"""The benchmark of linearsfm_tpu_torch (see run.py and README.md)."""
