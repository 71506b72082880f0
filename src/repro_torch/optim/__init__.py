"""Optimizer and learning-rate schedules of the LM trainer (the port's
`repro.optim`): `adamw` (bf16 compute weights over float32 master
weights and moments) and `schedules` (cosine, WSD)."""
