"""The plain reference of the benchmark: float32 PyTorch written from the
published models and methods. It imports nothing of the program under test
and takes nothing the program made: weights and inputs come from the
benchmark, everything derived from them is worked out again here."""
