"""Parallelism over ``torch.distributed``: sequence parallelism
(:mod:`.sequence`)."""
