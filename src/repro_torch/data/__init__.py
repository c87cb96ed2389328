from .synthetic import TokenStream, chembl_like

__all__ = ["TokenStream", "chembl_like"]
