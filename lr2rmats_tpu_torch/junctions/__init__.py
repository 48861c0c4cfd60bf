"""Short-read junction counting of the port (verify and counts on the device)."""
