"""The stream instances of the K1 and K2 templates as CUDA kernels
(``csrc/stream.cu``).

  * K1 ``_emit_streaming`` (``src/repro/codegen/emit.py:410``) with the
    copy, triad and init bodies: D row streams (rows ``r + k·seg``), one
    warp per row slot, ``seg / bm`` blocks, as ``gemver.cu``; init is
    writes-only (no read stream, D store positions).  A lane moves 16
    bytes a load and a store in every type: 4 elements of a 128-element
    sub-portion in f32, 8 elements of a pair of adjacent ones in bf16
    and f16 (an odd last sub-portion of a step 8 bytes).
  * K2 ``_emit_reduction`` (``src/repro/codegen/emit.py:491``) with the
    read body, on ``x2 = x.reshape(D, seg·cols)``.  Its block plan is D
    rows of ``seg·cols`` columns, so :func:`read_split` (pass 1) runs a
    grid over column chunks, two blocks per SM, each writing the f32
    partial sums of its chunk of the D streams ``[chunks, D]``; a lane
    loads 16 bytes a unit in every type (:func:`read_units`) and keeps
    the next step's loads in flight while it adds.  :func:`read_merge`
    (pass 2) folds each stream's partials in one warp: lane ``l`` sums
    chunks ``l, l+32, ...`` in order, then a shuffle tree, the order of
    :func:`read_merge_plain`.

:func:`emit` launches the kernels on CUDA tensors (or raises) and runs
their plain versions on CPU tensors: the spec through
``loopir.evaluate`` for K1, and for the read the spec body over each
chunk and an in-order sum.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.codegen import loopir
from repro_torch.codegen.transforms import LANE, BlockPlan
from repro_torch.core.striding import StridingConfig
from repro_torch.kernels import cuda

__all__ = ["COPY", "TRIAD", "INIT", "READ", "READ_MERGE", "emit",
           "READ_BLOCKS_PER_SM", "read_chunks", "read_units", "read_split",
           "read_merge", "read_split_plain", "read_merge_plain"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# stream_copy_launch(dtype, x, o, rows, cols, d, bm, ns, interleaved,
#                    stream)
COPY = cuda.CudaKernel("stream_copy", "stream", "stream_copy_launch",
                       [_I, _P, _P, _I, _I, _I, _I, _I, _I])
# stream_triad_launch(dtype, b, c, o, alpha, rows, cols, d, bm, ns,
#                     interleaved, stream)
TRIAD = cuda.CudaKernel("stream_triad", "stream", "stream_triad_launch",
                        [_I, _P, _P, _P, _F, _I, _I, _I, _I, _I, _I])
# stream_init_launch(dtype, o, value, rows, cols, d, bm, ns, interleaved,
#                    stream)
INIT = cuda.CudaKernel("stream_init", "stream", "stream_init_launch",
                       [_I, _P, _F, _I, _I, _I, _I, _I, _I])
# read_split_launch(dtype, x, part, w, d, spc, chunks, interleaved, stream)
READ = cuda.CudaKernel("stream_read", "stream", "read_split_launch",
                       [_I, _P, _P, _I, _I, _I, _I, _I])
# read_merge_launch(part, y, d, chunks, stream)
READ_MERGE = cuda.CudaKernel("stream_read_merge", "stream",
                             "read_merge_launch", [_P, _P, _I, _I])

_PLAIN_SMS = 132                   # chunks of the plain read split on a CPU
READ_BLOCKS_PER_SM = 2             # read_split's __launch_bounds__ minimum
_WARP = 32


def read_chunks(bp: BlockPlan, sms: int,
                per_sm: int = READ_BLOCKS_PER_SM) -> tuple[int, int]:
    """``(sub-portions per chunk, chunks)`` of the read's pass 1: the
    ``cols / 128`` sub-portions of each stream row are cut into chunks
    so the grid has ``per_sm`` blocks per SM (one wave at the default),
    no chunk empty."""
    nsub = bp.cols // LANE
    chunks = max(1, min(nsub, per_sm * sms))
    spc = -(-nsub // chunks)
    return spc, -(-nsub // spc)


def read_units(n_sub: int, itemsize: int) -> list[tuple[int, int]]:
    """The loads of one lane over a chunk of ``n_sub`` sub-portions, as
    ``(first sub-portion, bytes)``: 16 bytes a unit, a sub-portion's 4
    elements in f32 and a pair's 8 in 16-bit types, where an odd last
    sub-portion takes one 8-byte load (``csrc/stream.cu`` ``ReadSteps``)."""
    per = 2 if itemsize == 2 else 1
    units = [(q, 16) for q in range(0, n_sub - n_sub % per, per)]
    return units + ([(n_sub - 1, 8)] if n_sub % per else [])


def read_split_plain(spec: loopir.TraversalSpec, bp: BlockPlan, x2,
                     spc: int, chunks: int) -> torch.Tensor:
    """Plain version of pass 1: the spec body over each column chunk of
    the D stream rows, ``[chunks, D]`` f32."""
    w = spc * LANE
    return torch.stack([spec.body({spec.reads[0].array: x2[:, c * w:
                                                           (c + 1) * w]})
                        for c in range(chunks)]).float()


def read_merge_plain(part: torch.Tensor) -> torch.Tensor:
    """Plain version of pass 2, in the kernel's order: lane ``l`` of 32
    sums the partials of chunks ``l, l+32, ...`` in order from the sum's
    identity, then the lanes fold pairwise, ``l`` with ``l+16``, then
    ``l+8``, ``l+4``, ``l+2``, ``l+1``."""
    chunks, d = part.shape
    rounds = -(-chunks // _WARP)
    padded = torch.zeros(rounds * _WARP, d, dtype=torch.float32,
                         device=part.device)
    padded[:chunks] = part
    lanes = torch.zeros(_WARP, d, dtype=torch.float32, device=part.device)
    for block in padded.view(rounds, _WARP, d):
        lanes = lanes + block
    n = _WARP
    while n > 1:
        n //= 2
        lanes = lanes[:n] + lanes[n:2 * n]
    return lanes[0]


def read_split(spec: loopir.TraversalSpec, bp: BlockPlan, x2,
               config: StridingConfig | None = None,
               per_sm: int = READ_BLOCKS_PER_SM) -> torch.Tensor:
    """Pass 1: f32 partial sums ``[chunks, D]`` (``per_sm`` chunks an SM:
    a sweep's)."""
    if not x2.is_cuda:
        return read_split_plain(spec, bp, x2, *read_chunks(bp, _PLAIN_SMS))
    cuda.check_operands(spec.name, [x2], [(bp.rows, bp.cols)])
    sms = torch.cuda.get_device_properties(x2.device).multi_processor_count
    spc, chunks = read_chunks(bp, sms, per_sm)
    d = bp.d
    interleaved = config is not None and config.arrangement == "interleaved"
    part = torch.empty(chunks, d, dtype=torch.float32, device=x2.device)
    READ(x2.device, cuda.dtype_code(x2.dtype), x2.data_ptr(), part.data_ptr(),
         bp.cols, d, spc, chunks, int(interleaved))
    return part


def read_merge(part: torch.Tensor) -> torch.Tensor:
    """Pass 2: ``y [D]`` f32."""
    if not part.is_cuda:
        return read_merge_plain(part)
    if (part.dtype != torch.float32 or part.ndim != 2
            or not part.is_contiguous()):
        raise ValueError("stream_read merge: partials must be contiguous "
                         "2-D f32")
    y = torch.empty(part.shape[1], dtype=torch.float32, device=part.device)
    READ_MERGE(part.device, part.data_ptr(), y.data_ptr(), part.shape[1],
               part.shape[0])
    return y


def emit(spec: loopir.TraversalSpec, bp: BlockPlan, arrays, scalars,
         config: StridingConfig | None = None, device=None):
    """Run a (padded) stream spec through its K1 or K2 kernel."""
    if spec.name == "stream_read":
        return read_merge(read_split(spec, bp, arrays[0], config))
    if spec.name == "stream_init":
        (value,) = scalars
        dtype = spec.out_dtypes()[0]
        if device.type != "cuda":
            return loopir.evaluate(spec, [value], device=device)
        o = torch.empty(bp.rows, bp.cols, dtype=dtype, device=device)
        cuda.check_operands(spec.name, [o], [(bp.rows, bp.cols)])
        INIT(device, cuda.dtype_code(dtype), o.data_ptr(), float(value),
             *cuda.sweep_geometry(bp, config))
        return o
    a = arrays[0]
    if not a.is_cuda:
        return loopir.evaluate(spec, list(arrays) + list(scalars))
    shapes = [(bp.rows, bp.cols)] * len(arrays)
    cuda.check_operands(spec.name, arrays, shapes)
    o = torch.empty(bp.rows, bp.cols, dtype=a.dtype, device=a.device)
    geometry = cuda.sweep_geometry(bp, config)
    if spec.name == "stream_copy":
        COPY(a.device, cuda.dtype_code(a.dtype), a.data_ptr(), o.data_ptr(),
             *geometry)
    elif spec.name == "stream_triad":
        (alpha,) = scalars
        TRIAD(a.device, cuda.dtype_code(a.dtype), a.data_ptr(),
              arrays[1].data_ptr(), o.data_ptr(), float(alpha), *geometry)
    else:
        raise NotImplementedError(f"{spec.name}: not a stream instance")
    return o
