"""Data-parallel helpers on ``torch.distributed`` (port of
``repro/distributed``)."""
