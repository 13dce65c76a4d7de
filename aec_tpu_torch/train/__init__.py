"""Training: loop, checkpoints, metrics (``aec_tpu/train``)."""

__all__ = ["metrics", "checkpoints", "loop", "generic", "stoi"]


def __getattr__(name):
    """The submodules on first use: the model modules import
    ``train.metrics`` and the trainers import the models, so the package
    imports its submodules lazily."""
    if name in __all__:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
