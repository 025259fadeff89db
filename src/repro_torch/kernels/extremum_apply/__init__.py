from .ops import extremum_apply  # noqa: F401
