"""The two-pass pipeline and the command line of the port."""
