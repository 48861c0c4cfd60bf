from .gtf import read_anno_trans, read_gtf_trans, write_read_trans, ChrNames
from .fasta import read_fasta, read_fastq_or_fasta, Genome
