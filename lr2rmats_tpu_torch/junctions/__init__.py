"""Junction extraction from alignments and short-read junction counting
(verify and counts on the device)."""
