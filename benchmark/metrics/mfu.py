"""mfu: the benchmark's model-FLOP count of every tracking and mapping
iteration of the window (bench_core/flops.py, from the configuration's
schedule) over the window's wall time, as a share of the H100's float32
peak outside the tensor cores (67 TFLOP/s): the port runs its trunks on
bf16-rounded operands in float32 with TF32 off. A traced run leaves the
span the profiler ran in out of both."""


def read(run):
    return 100.0 * run.flops / run.timed_s / run.peak_flops
