"""Tools of the port run as ``python -m alfalfa_tpu_torch.tools.<name>``:
the native layer's sanitizer fuzz run (sanitize_fuzz) and the card's memory
check (poison_check)."""
