"""The port's telemetry at its ``detail`` level, for the tests that read
its detail counters; test modules import the fixture by name."""

import pytest


@pytest.fixture
def detail_telemetry():
    """The port's telemetry at its ``detail`` level, its records cleared;
    the default level again afterwards. Yields a function giving a detail
    counter (``survivor_share``, ``skip_share``, ``minimize_kernel_share``)
    of the newest call record: one value per matcher step, per scan or lane
    (per minimize for ``minimize_kernel_share``)."""
    from libpointmatcher_tpu_torch import telemetry

    telemetry.set_level("detail")
    telemetry.reset()

    def shares(name):
        return telemetry.snapshot()[-1]["counters"].get(name, [])

    yield shares
    telemetry.set_level("spans")
    telemetry.reset()
