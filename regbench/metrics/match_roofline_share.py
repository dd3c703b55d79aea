"""The matching kernels' share of their bytes roofline, in %: the bytes any
exact 1-NN of these inputs must move (each valid query row and each map row
read once a step, each (distance, row) written once; ``yardstick.py``) at
3.35 TB/s, over the device time of the cell's matching kernels
(``match_kernels`` of its file, by name) in the profiled sub-window. The
count follows the inputs, not a schedule, so a better pruning cannot push
it over 100%."""

from regbench import yardstick


def read(ctx):
    if not ctx.match_device_s or not ctx.match_bytes:
        return None
    return 100.0 * ctx.match_bytes / yardstick.HBM_BYTES_PER_S / ctx.match_device_s
