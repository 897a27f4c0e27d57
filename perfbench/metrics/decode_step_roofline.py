"""Share of its roofline that ``decode_step`` reached in the traced stretch:
launches x the bound of one (``roofline/decode_step.py``, the larger of bytes
over 3.35e12 B/s and operations over 989e12 FLOP/s) over their summed
device time in ``torch.profiler``'s trace."""
from perfbench.metrics._util import roofline_share


def read(run):
    return roofline_share(run, "decode_step")
