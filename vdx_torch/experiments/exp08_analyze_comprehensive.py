"""Experiment 08: comprehensive analysis, trends, agreement and
recommendations (port of experiments/08_analyze_comprehensive.py: a thin
CLI over vdx_torch.analysis.comprehensive; pandas on the host).

    python -m vdx_torch.experiments.exp08_analyze_comprehensive \\
        [--input JSON] [--output DIR]
"""

from vdx_torch.analysis.comprehensive import main

if __name__ == "__main__":
    main()
