from . import periods, discount  # noqa: F401
