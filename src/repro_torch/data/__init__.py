from .pipeline import (ShardedLoader, SyntheticLM, TokenDataset,
                       make_loader)

__all__ = ["ShardedLoader", "SyntheticLM", "TokenDataset", "make_loader"]
