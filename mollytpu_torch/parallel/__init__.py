from . import replicas  # noqa: F401
