"""Training on torch: AdamW, the train step, checkpoints, the loop
(port of ``repro/train``)."""
