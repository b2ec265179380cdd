from . import platform, roofline, stats, stream  # noqa: F401
from .stats import StatRegistry, csv_header, csv_rows  # noqa: F401
