from . import points  # noqa: F401
