"""Tools of the port run as ``python -m alfalfa_tpu_torch.tools.<name>``:
the native layer's sanitizer fuzz run (sanitize_fuzz), the card's memory
check (poison_check), the authored feature streams (feature_streams), and
the corpus grouped into batches of different streams (corpus)."""
