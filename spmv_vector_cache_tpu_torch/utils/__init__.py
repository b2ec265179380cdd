from . import platform, stats  # noqa: F401
from .stats import StatRegistry, csv_header, csv_rows  # noqa: F401
