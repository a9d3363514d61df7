"""The port's benchmark: one run of one cell (`run.py`), the cells' pieces
found by name (`spec.py`), and the yardstick they are held to."""
