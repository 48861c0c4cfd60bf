"""Entry kinds: one module per kind, named by a traffic mix's `entry`."""
