"""The reference: plain NumPy answers for the benchmark's queries; imports nothing of the program."""
