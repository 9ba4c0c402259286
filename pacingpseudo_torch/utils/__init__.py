"""Small host-side helpers of the port."""
from .meters import AvgMeter
