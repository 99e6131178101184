"""Training: AdamW and its schedules, and the training step and loop
(counterparts of ``repro.training``)."""
