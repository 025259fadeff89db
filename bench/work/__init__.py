"""Work formulas: the least bytes and operations a kernel call needs, and
the model FLOPs of an incremental step."""
