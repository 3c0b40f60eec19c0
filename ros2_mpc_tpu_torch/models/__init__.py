from . import unicycle

__all__ = ["unicycle"]
