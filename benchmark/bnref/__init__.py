"""The benchmark's plain reference: Python ints only, nothing of the program."""
