"""The minimizer index (host) and its lookup on the device."""
