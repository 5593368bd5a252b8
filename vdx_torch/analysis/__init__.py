"""The grid study's analysis layer (port of vdx/analysis/): pandas
tables and CSV files over the metric JSON, run on the host that reads
the files. Importing it loads pandas; nothing else in the port imports
it (the CLI's ``analyze`` does, when it runs)."""
from vdx_torch.analysis import basic, comprehensive
from vdx_torch.analysis.common import METRICS_07, METRICS_08, PRIMARY_METRICS, load_results

__all__ = ["basic", "comprehensive", "METRICS_07", "METRICS_08", "PRIMARY_METRICS", "load_results"]
