from .mesh import replicate_batch

__all__ = ['replicate_batch']
