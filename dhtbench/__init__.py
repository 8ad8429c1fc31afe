"""The benchmark of ``opendht_tpu_torch``: ``python3 -m dhtbench.run``."""
