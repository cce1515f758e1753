"""The reduction of a profiler trace: launch correlation to spans, names
to stages, busy and idle time."""

from portbench import trace


def X(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


def test_summarize_attributes_by_launch_and_name():
    ev = [
        X("user_annotation", "portbench.backward", 0, 10),
        X("user_annotation", "portbench.operator", 10, 2),
        X("user_annotation", "portbench.forward", 12, 8),
        X("user_annotation", "portbench.sync", 20, 30),
        X("cuda_runtime", "cudaLaunchKernel", 1, 1, correlation=1),
        X("cuda_runtime", "cudaMemcpyAsync", 3, 1, correlation=2),
        X("cuda_runtime", "cudaLaunchKernel", 11, 1, correlation=3),
        X("kernel", "void decompress_zdft_fft_kernel<true, float>(Args)",
          5, 4, correlation=1),
        X("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 9, 3,
          correlation=2),
        X("kernel", "elementwise_kernel<mul>", 13, 2, correlation=3),
        # a port kernel whose launch the trace lacks
        X("kernel", "void fft_plane_kernel<true, float>(A)", 20, 6,
          correlation=99),
        X("kernel", "void zdft_compress_fft_kernel<true, float>(A)", 30, 5),
    ]
    s = trace.summarize(ev, trace.load_stages())
    by = {o.name: (o.stage, o.span) for o in s.ops}
    assert by["void decompress_zdft_fft_kernel<true, float>"] == \
        ("z", "backward")
    assert by["Memcpy DtoD"] == ("torch", "backward")
    assert by["elementwise_kernel<mul>"] == ("torch", "operator")
    assert by["void fft_plane_kernel<true, float>"] == ("xy", "program")
    assert by["void zdft_compress_fft_kernel<true, float>"] == \
        ("z", "program")
    assert s.window_us == 50
    # busy: [5, 12], [13, 15], [20, 26] and [30, 35]
    assert s.busy_us == 20
    assert s.seconds(stage="z") == 9e-6
    assert s.seconds(stage="torch", spans=trace.PORT_SPANS) == 3e-6
    assert s.count(trace.port_spans()) == 4
    gaps = dict(s.top_gaps())
    assert abs(sum(gaps.values()) - 30e-6) < 1e-12
    assert gaps["sync"] > gaps["backward"]
    assert s.top_ops(1)[0][0] == "void fft_plane_kernel<true, float>"
