"""The benchmark of libpointmatcher_tpu_torch: scan-to-map registration
served on one H100 (see README.md)."""
