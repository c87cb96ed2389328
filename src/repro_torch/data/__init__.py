from .synthetic import TokenStream

__all__ = ["TokenStream"]
