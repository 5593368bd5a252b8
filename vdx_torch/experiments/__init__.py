"""The experiment CLIs on the port (port of vdx's experiments/): one
runnable module per CLI, named for it,

    python -m vdx_torch.experiments.exp01_baseline_generation [--tiny]
    python -m vdx_torch.experiments.exp02_architecture_inspection [--tiny]
    python -m vdx_torch.experiments.exp03_trace_forward_pass [--tiny]
    python -m vdx_torch.experiments.exp05_grid_search_ablation [--tiny] --yes
    python -m vdx_torch.experiments.exp06_measure_grid_search
    python -m vdx_torch.experiments.exp07_analyze_grid_search
    python -m vdx_torch.experiments.exp08_analyze_comprehensive

with vdx's flags; those that run the port's models on a device take
``--device`` (default ``cuda``). ``experiments_common.load_pipeline`` is
the shared loader. Writing frames (01, 05) and the analyses (07, 08)
need Pillow and pandas on the host that runs them.
"""
