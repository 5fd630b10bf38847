"""knn.roofline: in the profiled part, the least time the card could take
for the k-NN calls made there (bench_core/flops.knn_query_cost: bytes over
3.35 TB/s or operations over 67 TFLOP/s, whichever is larger) as a share
of the select kernel's device time, by kernel name."""


def read(run):
    t = run.trace
    if not t or t["knn_kernel_s"] <= 0 or t["knn_bound_s"] <= 0:
        return None
    return 100.0 * t["knn_bound_s"] / t["knn_kernel_s"]
