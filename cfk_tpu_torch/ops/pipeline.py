"""Double-buffered chunk pipelining and the captured training iteration.

The port of ``cfk_tpu/ops/pipeline.py``.  Every tiled, bucketed, segment
and padded-chunk half-step walks its work in chunks.  In the JAX package
the whole walk is one XLA program (``lax.scan`` inside ``jit``) and
``prefetch_scan`` restructures it as a software pipeline: chunk c+1's fetch
is issued before chunk c's compute, and XLA's scheduler overlaps the two.
On the card the same two ideas become:

- ``prefetch_scan`` with a side stream: where a chunk's fetch does device
  work of its own — K5 ``gather_rows`` writing the materialized stream on
  the gather-off schedule — it runs on a second CUDA stream, into one of
  two buffers the caller owns, while the previous chunk's Gram runs on the
  current stream.  Events keep the order: the fetch of chunk c+1 waits for
  the compute of chunk c−1 (the last reader of its buffer), and the compute
  of chunk c waits for chunk c's fetch.  Where the fetch is a slice (the
  gather inside the kernels, ``index_fetch``) there is nothing to overlap
  and the scan runs its calls in order on the current stream.
- ``CapturedStep``: one whole training iteration, both halves, captured
  into a CUDA graph after an eager warm-up iteration and replayed for the
  rest, so the host issues nothing per chunk — the counterpart of the
  iteration loop compiled into one program.  Opt-in (``ALSConfig.capture``):
  the port's iterations are bound by their kernels, so a replay saves
  little and the capture costs more than that at a few iterations.

The math is unchanged: the same fetches and computes in the same order per
chunk, so the factors are bit-identical to the serial loop (``overlap=
False``, the A/B baseline) wherever the kernels are deterministic
(``tests/test_torch_pipeline.py`` on the CPU, ``tests/test_torch_gpu.py``
on the card).  The ring exchanges of the reference's sharded trainers,
``apply_overlap_xla_flags`` and the async collective permute have no
counterpart until the port runs on several cards.
"""

from __future__ import annotations

import time

import torch


def default_overlap() -> bool:
    """Process-wide default for the pipelined schedule (the production
    mode); per-call ``overlap=`` and ``ALSConfig.overlap`` override it."""
    return True


def resolve_overlap(overlap) -> bool:
    """Per-call override if given, else the process default."""
    return default_overlap() if overlap is None else bool(overlap)


def index_fetch(flat, cap):
    """A ``prefetch_scan`` fetch that slices chunk ``i``'s [cap] window out
    of a flat tensor (a view: no device work) — the fetch of every schedule
    whose gather happens inside the Gram kernels."""
    def fetch(i):
        return flat[i * cap:(i + 1) * cap]

    return fetch


def fetch_stream(device: torch.device, overlap) -> torch.cuda.Stream | None:
    """The side stream a device-side fetch runs on: a new CUDA stream with
    the pipeline on and ``device`` a card, else None (the fetch then runs
    in order on the current stream — the serial schedule, and the CPU)."""
    if not resolve_overlap(overlap) or torch.device(device).type != "cuda":
        return None
    return torch.cuda.Stream(device=device)


def prefetch_scan(fetch, compute, num_chunks, init, xs=None, *,
                  stream: torch.cuda.Stream | None = None):
    """Software-pipelined chunk scan with a one-chunk prefetch distance.

    ``fetch(i) -> buf`` produces chunk ``i``'s input; ``compute(carry, buf,
    x, i) -> (carry, y)`` consumes it (``x`` is ``xs[i]``, or None).  The
    schedule::

        buf0 = fetch(0)                         # prologue
        step i: fetch(i+1)  ||  compute(buf_i)  # double buffer

    The prefetch index clamps to ``num_chunks − 1``: the last step's fetch
    would read past the chunks, and since its buffer is dead the port does
    not issue it (on the card it would cost a K5 pass).  Returns ``(carry,
    ys)`` with ``ys`` the list of per-chunk outputs.

    ``stream`` (a ``torch.cuda.Stream``) runs every fetch on that stream:
    the fetch may then write only into buffers allocated on the current
    stream before the scan, chunk ``i`` into buffer ``i % 2`` — the fetch of
    chunk i+1 waits for the compute of chunk i−1, which last read that
    buffer, and the compute of chunk i waits for chunk i's fetch; the scan
    ends with the current stream waiting for the side stream.  Without it
    the calls run in the same order on the current stream (and on the CPU).
    """
    carry, ys = init, []
    if num_chunks <= 0:
        return carry, ys
    take = (lambda i: None) if xs is None else (lambda i: xs[i])
    if stream is None:
        buf = fetch(0)
        for i in range(num_chunks):
            nxt = fetch(i + 1) if i + 1 < num_chunks else None
            carry, y = compute(carry, buf, take(i), i)
            ys.append(y)
            buf = nxt
        return carry, ys
    main = torch.cuda.current_stream(stream.device)
    stream.wait_stream(main)
    with torch.cuda.stream(stream):
        buf = fetch(0)
        ready = stream.record_event()
    done = [None, None]  # the compute that last read buffer 0 / 1
    for i in range(num_chunks):
        main.wait_event(ready)
        nxt = None
        if i + 1 < num_chunks:
            with torch.cuda.stream(stream):
                freed = done[(i + 1) % 2]
                if freed is not None:
                    stream.wait_event(freed)
                nxt = fetch(i + 1)
                nxt_ready = stream.record_event()
        carry, y = compute(carry, buf, take(i), i)
        done[i % 2] = main.record_event()
        ys.append(y)
        if nxt is not None:
            buf, ready = nxt, nxt_ready
    main.wait_stream(stream)
    return carry, ys


def chunk_map(piece, arrs, num_chunks):
    """``[piece(*(a[c] for a in arrs)) for c in range(num_chunks)]`` as a
    ``prefetch_scan``: chunk c+1's operands are fetched (sliced) before
    ``piece`` runs on chunk c.  A slice is no device work, so there is no
    side stream and nothing for ``overlap`` to switch: the calls are the
    plain map's, in its order.  ``arrs`` is a tuple of [num_chunks, ...]
    tensors; returns the list of ``piece``'s outputs."""
    def fetch(i):
        return tuple(a[i] for a in arrs)

    def compute(carry, buf, _x, _i):
        return carry, piece(*buf)

    return prefetch_scan(fetch, compute, num_chunks, None)[1]


# -- the captured iteration ----------------------------------------------------

def launch_counters() -> list:
    """Every kernel wrapper that counts its launches (``<fn>.launches``)."""
    from cfk_tpu_torch.ops.kernels import (
        binv_kernel,
        gram_kernel,
        solve_kernel,
    )

    seen, out = set(), []
    for mod in (gram_kernel, solve_kernel, binv_kernel):
        for fn in vars(mod).values():
            if callable(fn) and hasattr(fn, "launches") and id(fn) not in seen:
                seen.add(id(fn))
                out.append(fn)
    return out


class CapturedStep:
    """One training iteration captured into a CUDA graph and replayed.

    ``step(state, out)`` runs one iteration on the tuple of factor tensors
    ``state``; with ``out`` None it returns the new tensors (the eager
    form), with ``out`` a tuple of tensors it writes each half's result into
    them in place as soon as the half is solved (the captured form; ``out``
    may be ``state`` itself, since each half reads only what the iteration
    has not overwritten yet).  ``run(state, iterations)``:

    1. runs iteration 1 eagerly on a side stream — the warm-up PyTorch asks
       for before a capture (cuBLAS handles and workspaces, lazy module
       state, the kernels' first loads), on the stream the capture uses;
    2. captures one whole iteration into a ``torch.cuda.CUDAGraph`` whose
       inputs and outputs are iteration 1's result tensors (the static
       state);
    3. replays it for iterations 2…N on the current stream.

    A kernel wrapper's ``launches`` counter counts the launches made through
    it: iteration 1's.  The capture launches nothing, so its calls are taken
    back off the counters, and a replay runs no Python, so it adds nothing.
    What a replay runs is read from the graph itself: ``stats`` holds the
    wrappers' calls the capture recorded (``launches_per_replay``), the
    graph's kernel nodes by function (``graph_kernels``, from libcuda),
    the seconds of iteration 1, of the capture, of the instantiation and of
    the replays (iteration 1 and the replays each end in a sync), the
    replays, and the bytes the graph's memory pool reserved.
    """

    def __init__(self, step) -> None:
        self.step = step
        self.graph = None
        self.stats: dict = {}

    def run(self, state, iterations: int):
        if iterations < 2:
            raise ValueError("a captured step needs >= 2 iterations; run "
                             "one iteration eagerly")
        dev = state[0].device
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(main)
        counters = launch_counters()
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            static = tuple(self.step(state, None))
        # torch.cuda.graph empties the cache on entry: do it first, so the
        # reserved bytes' growth is the graph's pool.
        torch.cuda.synchronize(dev)
        eager_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(dev)
        before = [fn.launches for fn in counters]
        # keep_graph: instantiate apart from the capture, to time each.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=side):
            self.step(static, static)
        capture_s = time.perf_counter() - t0
        recorded = []
        for fn, n0 in zip(counters, before):
            recorded.append(fn.launches - n0)
            fn.launches = n0
        t0 = time.perf_counter()
        graph.instantiate()
        instantiate_s = time.perf_counter() - t0
        main.wait_stream(side)
        t0 = time.perf_counter()
        for _ in range(iterations - 1):
            graph.replay()
        torch.cuda.synchronize(dev)
        replays_s = time.perf_counter() - t0
        for t in static:
            t.record_stream(main)  # allocated on the side stream
        self.graph = graph
        t0 = time.perf_counter()
        kernels = graph_kernels(graph)
        self.stats = dict(
            eager_s=eager_s, capture_s=capture_s,
            instantiate_s=instantiate_s, replays=iterations - 1,
            replays_s=replays_s,
            graph_pool_bytes=torch.cuda.memory_reserved(dev) - reserved0,
            launches_per_replay={fn.__name__: n for fn, n
                                 in zip(counters, recorded) if n},
            graph_kernels=kernels,
            graph_walk_s=time.perf_counter() - t0)
        return static


def kernel_base_name(mangled: str) -> str:
    """A kernel's function name from its mangled symbol: the last name of
    its (nested) qualified name, template arguments and parameters dropped
    (``_Z16reg_solve_kernelILi64EEv…`` → ``reg_solve_kernel``); anything
    that is not an Itanium symbol is returned whole."""
    if not mangled.startswith("_Z"):
        return mangled
    nested = mangled[2:3] == "N"
    i, name = 2 + nested, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        n = int(mangled[i:j])
        name, i = mangled[j:j + n], j + n
        if not nested:  # what follows is template arguments or parameters
            break
    return name


def graph_kernels(graph) -> dict[str, int] | None:
    """The kernel nodes of a captured ``torch.cuda.CUDAGraph`` (made with
    ``keep_graph=True``), counted by function name (``kernel_base_name``),
    read through libcuda: ``cuGraphGetNodes``, ``cuGraphNodeGetType``,
    ``cuGraphKernelNodeGetParams_v2`` and ``cuFuncGetName`` (or
    ``cuKernelGetName``, CUDA 12.3 on).  None where libcuda cannot say."""
    import ctypes

    try:
        lib = ctypes.CDLL("libcuda.so.1")
        raw = ctypes.c_void_p(graph.raw_cuda_graph())
        count = ctypes.c_size_t(0)
        if lib.cuGraphGetNodes(raw, None, ctypes.byref(count)) != 0:
            return None
        nodes = (ctypes.c_void_p * count.value)()
        if lib.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) != 0:
            return None
        kind = ctypes.c_int(0)
        # CUDA_KERNEL_NODE_PARAMS_v2: func at byte 0, kern at byte 56.
        params = (ctypes.c_uint64 * 16)()
        name = ctypes.c_char_p()
        out: dict[str, int] = {}
        for node in nodes[:count.value]:
            node = ctypes.c_void_p(node)
            if lib.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
                return None
            if kind.value != 0:  # CU_GRAPH_NODE_TYPE_KERNEL
                continue
            if lib.cuGraphKernelNodeGetParams_v2(node, params) != 0:
                return None
            func, kern = params[0], params[7]
            if func and lib.cuFuncGetName(ctypes.byref(name),
                                          ctypes.c_void_p(func)) == 0:
                pass
            elif kern and lib.cuKernelGetName(ctypes.byref(name),
                                              ctypes.c_void_p(kern)) == 0:
                pass
            else:
                return None
            key = kernel_base_name(name.value.decode())
            out[key] = out.get(key, 0) + 1
        return out
    except (OSError, AttributeError, RuntimeError):
        return None


# The kernel functions whose node a wrapper's call adds to a graph, one a
# call (a Gram call's split-segment reduce kernel, where it has one, is not
# counted; rows 11 and 12 share one kernel).
_GRAM_UNITS = ("gram_kernel", "gram_pair_kernel", "gram_solve_kernel")
_SPD_BATCH = ("spd_batch_kernel",)


def wrapper_kernels(name: str) -> tuple[str, ...]:
    """The kernel functions a call of wrapper ``name`` launches one of."""
    if name.startswith("gram_"):
        return _GRAM_UNITS
    if name in ("gauss_solve", "gauss_solve_multi"):
        return _SPD_BATCH
    return (f"{name}_kernel",)


def replay_launches(stats: dict) -> dict[str, tuple[int, int]] | None:
    """What a replay of a ``CapturedStep`` launches, against what its
    capture recorded: for each group of kernel functions
    (``wrapper_kernels``, joined by "+"), ``(calls, nodes)`` — the wrappers'
    calls the capture recorded, and the graph's kernel nodes of those
    functions.  They are equal when the graph holds every launch the
    wrappers made.  None where libcuda could not name the nodes."""
    nodes = stats.get("graph_kernels")
    if nodes is None:
        return None
    out: dict[str, tuple[int, int]] = {}
    for name, n in stats["launches_per_replay"].items():
        fns = wrapper_kernels(name)
        calls, _ = out.get("+".join(fns), (0, 0))
        out["+".join(fns)] = (calls + n, sum(nodes.get(f, 0) for f in fns))
    return out
