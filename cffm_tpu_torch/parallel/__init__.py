"""The row-sharded embedding engine on torch.distributed (flat exchange)."""
