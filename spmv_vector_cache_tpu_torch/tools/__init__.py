from . import realistic  # noqa: F401
