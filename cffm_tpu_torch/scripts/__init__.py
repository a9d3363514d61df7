"""Measurement scripts for the card: kernel micro-benches, probes and step
profiles. Each runs as `python -m cffm_tpu_torch.scripts.<name>` and has a
`main(argv=None)`; nothing runs at import."""
