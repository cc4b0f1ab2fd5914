"""The benchmark of `cppre_torch` on the H100: `python3 portbench/run.py --help`."""
