"""idle_share.modernbert: the device's idle share of the traced window."""
from benchmark.readers import idle_share as read  # noqa: F401
