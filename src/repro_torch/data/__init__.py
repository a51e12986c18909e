from .pipeline import (BatchSpec, MemmapCorpus, SyntheticLM, make_batches,
                       write_corpus)

__all__ = ["BatchSpec", "MemmapCorpus", "SyntheticLM", "make_batches",
           "write_corpus"]
