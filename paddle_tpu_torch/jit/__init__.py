"""Shape bucketing shared with the reference (no compiler: eager torch)."""
from .api import default_buckets  # noqa: F401
