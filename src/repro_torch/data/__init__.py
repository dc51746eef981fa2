from . import points, tokens  # noqa: F401
