"""Shape-bucketing request packer: many small jobs, one dispatch.

Counterpart of ``enterprise_warp_tpu/serve/packer.py`` (pure numpy, the
same contracts). A serving queue holds many small theta batches (a
per-pulsar noise posterior draw, one sky-scan grid chunk) against the
same model. Dispatching each on its own pays one device round trip per
request; the packer concatenates their rows IN ARRIVAL ORDER into
batches padded up to the AOT cache's bucket edges, so N requests become
ceil(total_rows / capacity) dispatches.

Contracts:

- **fixed serve width**: every batch for a model pads to that model's
  ONE configured bucket (its serve width). A batched evaluation's
  rounding may depend on the batch shape (a GEMM's blocking, a batched
  solver's algorithm choice), so a queue-depth-adaptive bucket would make
  a tenant's answer depend on who else was queued. At a FIXED width, a
  row's result is bit-independent of co-batched content, which is what
  makes the next contract provable;
- **padding is masked, never mixed in**: padding rows replicate the
  last real row (always a valid, finite theta — the evaluation must not
  see garbage), and the harvest slices out exactly the real rows. Each
  real row's result is bit-equal to serving that job alone (asserted
  across fill levels, one-job, and spill cases in
  ``tests/test_torch_serve.py``, and on the card by ``chip_smoke.py``);
- **spill**: a load larger than one width splits across several
  width-sized batches; a request may span batches, and its result
  assembles from per-batch segments (``PackedBatch.segments``);
- **FIFO**: rows are packed in submission order, so earlier requests
  complete no later than with sequential dispatch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["PackedBatch", "pack_requests", "split_batch"]


@dataclass
class PackedBatch:
    """One padded dispatch: ``rows`` is the (bucket, ndim) host
    array (``bucket`` = the model's serve width); ``segments`` maps
    its real rows back to requests as
    ``(request, req_row_start, batch_row_start, n_rows)``.
    ``n_jobs`` counts the requests this batch carries rows for."""

    model: str
    bucket: int
    rows: np.ndarray
    n_real: int
    segments: list = field(default_factory=list)

    @property
    def fill(self) -> float:
        """Real-row fraction of the dispatched batch (1.0 = no
        padding waste)."""
        return self.n_real / self.bucket if self.bucket else 0.0

    @property
    def n_jobs(self) -> int:
        return len({id(req) for req, _, _, _ in self.segments})


def pack_requests(requests, width):
    """Pack same-model ``requests`` (objects with ``.thetas`` of
    shape (n, ndim) and ``.model``) into :class:`PackedBatch` es of
    exactly ``width`` padded rows each. Returns the batch list; every
    input row appears in exactly one batch, in FIFO order."""
    if not requests:
        return []
    width = int(width)
    model = requests[0].model
    ndim = requests[0].thetas.shape[1]
    batches = []
    seg_rows: list = []      # accumulating (request, req_start, n)
    acc = 0

    def emit(n_real):
        rows = np.empty((width, ndim), dtype=np.float64)
        out = PackedBatch(model=model, bucket=width, rows=rows,
                          n_real=n_real)
        cursor = 0
        for req, start, n in seg_rows:
            rows[cursor:cursor + n] = req.thetas[start:start + n]
            out.segments.append((req, start, cursor, n))
            cursor += n
        if width > n_real:
            # valid-theta padding: replicate the last real row
            rows[n_real:] = rows[n_real - 1]
        batches.append(out)
        seg_rows.clear()

    for req in requests:
        if req.model != model:
            raise ValueError(
                f"pack_requests got mixed models ({req.model!r} vs "
                f"{model!r}) — group by model first")
        n = int(req.thetas.shape[0])
        start = 0
        while n > 0:
            take = min(n, width - acc)
            seg_rows.append((req, start, take))
            acc += take
            start += take
            n -= take
            if acc == width:
                emit(acc)
                acc = 0
    if acc:
        emit(acc)
    return batches


def split_batch(batch: PackedBatch):
    """Split a batch's real rows at the midpoint into two batches at
    the SAME bucket width — the quarantine bisection step
    (``driver.py``).

    The halves keep the original bucket so the fixed-serve-width
    contract holds: a clean row re-dispatched inside a half returns a
    result bit-equal to the original dispatch (row results at one
    width are bit-independent of co-batched content), which is what
    lets the driver finish a poisoned batch's innocent co-tenants with
    zero casualties. Segments spanning the cut are divided; padding
    replicates each half's last real row as usual."""
    if batch.n_real < 2:
        raise ValueError("cannot bisect a batch with fewer than 2 "
                         "real rows")
    cut = batch.n_real // 2
    halves = []
    for row_lo, row_hi in ((0, cut), (cut, batch.n_real)):
        n_real = row_hi - row_lo
        rows = np.empty((batch.bucket, batch.rows.shape[1]),
                        dtype=batch.rows.dtype)
        rows[:n_real] = batch.rows[row_lo:row_hi]
        rows[n_real:] = rows[n_real - 1]
        half = PackedBatch(model=batch.model, bucket=batch.bucket,
                           rows=rows, n_real=n_real)
        for req, req_start, batch_start, n in batch.segments:
            lo = max(batch_start, row_lo)
            hi = min(batch_start + n, row_hi)
            if lo < hi:
                half.segments.append(
                    (req, req_start + (lo - batch_start),
                     lo - row_lo, hi - lo))
        halves.append(half)
    return halves
