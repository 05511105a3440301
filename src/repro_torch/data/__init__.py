from .pipeline import BatchSpec, SyntheticLMDataset, make_batch_specs

__all__ = ["BatchSpec", "SyntheticLMDataset", "make_batch_specs"]
