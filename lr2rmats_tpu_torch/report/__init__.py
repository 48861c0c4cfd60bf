from .sortgtf import sort_gtf_lines, sort_gtf_file
