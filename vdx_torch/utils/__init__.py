from vdx_torch.utils.logging import EventLog, timed

__all__ = ["EventLog", "timed"]
