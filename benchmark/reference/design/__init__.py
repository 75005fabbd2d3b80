"""Host-side float64 filter design (runs once per plan, cached)."""

from .fracbank import get_frac_bank
from .halfband import get_hb_filter
from .lpfilter import build_lp_filter, get_lp_filter
from .wholestep import get_whole_stepping
