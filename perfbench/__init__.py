"""The benchmark of sonar_tpu_torch (``python3 perfbench/run.py --help``)."""
