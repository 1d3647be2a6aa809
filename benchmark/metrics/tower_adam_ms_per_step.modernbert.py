"""tower_adam_ms_per_step.modernbert: tower_adam_ms_per_step.bert's reading
over the ModernBERT cell's window: the device time of the fused Adam update
inside the program's `tower.adam` spans over the window's steps (16 a fit,
149.7M parameters a step)."""
from benchmark.harness import reader

read = reader("tower_adam_ms_per_step.bert")
