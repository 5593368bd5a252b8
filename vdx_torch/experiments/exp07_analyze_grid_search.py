"""Experiment 07: analyze grid-search results, per-video sweeps and optima
(port of experiments/07_analyze_grid_search.py: a thin CLI over
vdx_torch.analysis.basic; pandas on the host).

    python -m vdx_torch.experiments.exp07_analyze_grid_search \\
        [--input JSON] [--output DIR]
"""

from vdx_torch.analysis.basic import main

if __name__ == "__main__":
    main()
