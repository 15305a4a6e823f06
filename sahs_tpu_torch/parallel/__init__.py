from . import mesh  # noqa: F401
