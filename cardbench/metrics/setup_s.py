"""Seconds from the process's start to the window's start: imports, input
generation, the program's set-up (index, kernel build, warm-up call)."""


def read(rec):
    return rec["setup_s"]
