from .synthetic import TokenStream, chembl_like, lm_batches, make_lm_batch

__all__ = ["TokenStream", "chembl_like", "lm_batches", "make_lm_batch"]
