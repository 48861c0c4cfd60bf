"""Seed lookup of the port (the index table resident on the device)."""
