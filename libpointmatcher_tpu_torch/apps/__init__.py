"""Command-line applications (reference: examples/ + evaluations/), the
port's counterparts of ``libpointmatcher_tpu.apps``.

Run as ``python -m libpointmatcher_tpu_torch.apps.<name>``:

- ``icp_simple``       — minimal registration of two clouds (examples/icp_simple.cpp)
- ``icp``              — full CLI with YAML config and initial transform (examples/icp.cpp)
- ``icp_advance_api``  — introspection demo: match ratio, residuals (examples/icp_advance_api.cpp)
- ``icp_customized``   — chain built programmatically via registrars (examples/icp_customized.cpp)
- ``align_sequence``   — scan-to-map odometry over a cloud list (examples/align_sequence.cpp)
- ``build_map``        — batch map building with ground-truth poses (examples/build_map.cpp)
- ``compute_overlap``  — pairwise overlap-ratio matrix (examples/compute_overlap.cpp)
- ``filter_profiler``  — filter timing harness (examples/filterProfiler.cpp)
- ``list_modules``     — registry dump with parameter docs + bibliography (examples/list_modules.cpp)
- ``eval_solution``    — ETH 'Challenging datasets' protocol runner (evaluations/eval_solution.cpp)
- ``plot_results``     — text and CSV report of eval_solution's results
- ``golden_check``     — full-cloud golden-config sweep vs the reference's .ref_trans
- ``demo_pipeline``    — odometry, pose-graph refinement and trajectory error on a synthetic sequence
- ``scaling_bench``    — registrations/s of ``register_batch`` split over 1, n/2 and n local ranks

Every application that computes takes ``--device``: the card by default,
``--device cpu`` for the CPU. It is the port's device rule (entry points run
on the card unless asked for the CPU, and raise without one) carried to the
command line; no application falls back to the CPU on its own.
``scaling_bench`` also takes the group's backend (``--backend``): the
caller picks it, and the port never switches it.
"""
