"""The port's k-NN search and its kernels (counterpart of
``libpointmatcher_tpu.ops``)."""

from .knn import knn_brute_force  # noqa: F401
