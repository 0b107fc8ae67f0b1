"""Sharded training and serving over ``torch.distributed`` ranks."""
