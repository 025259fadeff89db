"""Plain PyTorch versions of the message-passing SpMM,
out[v] = sum_{(u, v)} w_uv * x[u] summed in fp32 and cast back to x's
dtype, and of the partition of a CSR's edges into the kernel's work
items."""
import torch


def segment_mm_ref(src, dst, w, x, n: int):
    """``src``/``dst`` ``[E]`` int32 or int64 edge ends, ``w [E]`` fp32,
    ``x [n_x, d]`` -> ``[n, d]``.  For fp32 ``x`` this is the full pass's
    segment-sum as it stood before the kernel (``index_add_`` in edge
    order)."""
    out = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, dst, x[src].float() * w[:, None])
    return out.to(x.dtype)


def _true_at(mask: torch.Tensor, count: int) -> torch.Tensor:
    """The indices of ``mask``'s ``count`` set entries, in order, without
    reading anything back (``nonzero`` would)."""
    slot = torch.where(mask, torch.cumsum(mask, 0) - 1, count)
    out = torch.empty(count + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, slot, torch.arange(mask.shape[0], device=mask.device))
    return out[:count]


def partition_ref(rowptr, budget: int):
    """The work items of ``ops.partition`` over the rows of ``rowptr
    [n+1]`` (a tensor or array), by vectorised ops on its device with one
    readback: ``(items [I, 4], long_rows, chunk_ptr, n_chunks)``, int32
    tensors and an int, as ``ops.partition`` defines them."""
    rowptr = torch.as_tensor(rowptr).long()
    dev, n = rowptr.device, rowptr.shape[0] - 1
    start, stop = rowptr[:-1], rowptr[1:]
    counts = stop - start
    long = counts > budget
    window = start // budget
    # an item of its own (or its chunks): a row whose last edge lies past
    # its first edge's window (every long row does)
    alone = (stop - 1) // budget > window
    rows = torch.arange(n, device=dev)
    # an item starts at every `budget`-th row, at a row that opens a
    # window, and at and after a lone row
    new = rows % budget == 0
    new[1:] |= (window[1:] != window[:-1]) | alone[1:] | alone[:-1]
    # items a row opens: its chunks, or one (a long row is alone, so it
    # opens an item)
    opens = torch.where(long, (counts + budget - 1) // budget, 1)
    n_firsts, n_long, n_opens = torch.stack(
        [new.sum(), long.sum(), opens.sum()]).tolist()
    n_chunks = n_opens - (n - n_long)
    firsts = _true_at(new, n_firsts)
    ends = torch.cat([firsts[1:], firsts.new_full((1,), n)])[:n_firsts]
    per = opens[firsts]
    n_items = n_firsts - n_long + n_chunks
    owner = torch.repeat_interleave(torch.arange(n_firsts, device=dev), per,
                                    output_size=n_items)
    k = torch.arange(n_items, device=dev) \
        - (torch.cumsum(per, 0) - per)[owner]
    first = firsts[owner]
    chunk = long[first]
    e0 = rowptr[first] + k * budget
    e1 = torch.where(chunk, torch.minimum(e0 + budget, rowptr[first + 1]),
                     rowptr[ends[owner]])
    slot = torch.cumsum(chunk, 0) - 1
    items = torch.stack([first, torch.where(chunk, ~slot, ends[owner]), e0,
                         e1], 1)
    # longest first, ties in row order
    items = items[torch.argsort(e0 - e1, stable=True)]
    long_rows = _true_at(long, n_long)
    chunk_ptr = torch.zeros(n_long + 1, dtype=torch.int64, device=dev)
    torch.cumsum(opens[long_rows], 0, out=chunk_ptr[1:])
    i32 = torch.int32
    return (items.to(i32).reshape(-1, 4), long_rows.to(i32),
            chunk_ptr.to(i32), n_chunks)
