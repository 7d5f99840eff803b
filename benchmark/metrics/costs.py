"""FLOP and byte counts of the port's work, from the configuration's
shapes and the counts a run measured, and the published peaks of one
NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).

Model FLOPs count a multiply and an add as two operations and only the
work the model needs on the valid (unpadded) rows and edges; a backward
pass counts twice its forward, so a training step is three forwards.
"""

BF16_FLOPS = 989e12  # tensor cores, dense
F32_FLOPS = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def sage_layer_flops(n_src, n_dst, n_edges, d_in, d_out):
    """One SAGE-mean layer, forward: W_self on the dsts (2 n_dst d_in
    d_out); W_neigh on the srcs when d_in > d_out, as the port projects
    before it aggregates, else on the dsts' means (2 n d_in d_out); the
    weighted sum over the edges, a multiply and an add per edge and
    column of the aggregated width (2 E d)."""
    before = d_in > d_out
    neigh = 2 * (n_src if before else n_dst) * d_in * d_out
    agg = 2 * n_edges * (d_out if before else d_in)
    return 2 * n_dst * d_in * d_out + neigh + agg


def sage_step_flops(dims, counts):
    """A training step of an L-layer SAGE: 3 x the forward over the blocks'
    valid counts ``counts`` = [num_nodes/0 .. num_nodes/L, num_edges/0 ..
    num_edges/L-1] (block l: num_nodes/l srcs, num_nodes/l+1 dsts,
    num_edges/l edges); ``dims`` = [in, hidden, ..., classes]."""
    L = len(dims) - 1
    fwd = sum(sage_layer_flops(counts[l], counts[l + 1], counts[L + 1 + l],
                               dims[l], dims[l + 1]) for l in range(L))
    return 3 * fwd


def k7_ops(n_edges, heads, width):
    """K7's f32 operations on a full-graph GATv2 layer, per edge and head:
    the src and dst rows added (O), the leaky ReLU, a compare and a
    multiply (2 O), the product with attn and its sum over O (2 O), the
    online softmax's exp and running max (2), and the message a * f_src
    multiplied and added into the output (2 O): E H (7 O + 2), the count
    of PERF.md's bound table."""
    return n_edges * heads * (7 * width + 2)


def k7_bytes(n_nodes, n_edges, heads, width, itemsize):
    """K7's compulsory bytes: the projection read once (N H O of
    ``itemsize``), the row pointer and the srcs read once, the f32 output
    written once."""
    return (n_nodes * heads * width * itemsize + (n_nodes + 1) * 4
            + n_edges * 4 + n_nodes * heads * width * 4)


def k7_bound_s(n_nodes, n_edges, heads, width, itemsize):
    """The least time K7 can take on one card: the larger of its f32
    operations over the f32 rate and its bytes over the HBM rate."""
    return max(k7_ops(n_edges, heads, width) / F32_FLOPS,
               k7_bytes(n_nodes, n_edges, heads, width, itemsize)
               / HBM_BYTES_PER_S)


def gat_layers(cfg):
    """[(d_in, heads, width)] of the configuration's GATv2 layers."""
    m, g = cfg["model"], cfg["graph"]
    out, d_in = [], g["n_feats"]
    for l in range(m["layers"]):
        width = g["n_classes"] if l == m["layers"] - 1 else m["hidden"]
        out.append((d_in, m["heads"][l], width))
        d_in = m["heads"][l] * width
    return out


def gat_pass_flops(cfg, n_nodes, n_edges):
    """A full-graph GATv2 pass: each layer's projection of every node
    (2 N d_in H O) and its attention (``k7_ops``)."""
    return sum(2 * n_nodes * d_in * h * w + k7_ops(n_edges, h, w)
               for d_in, h, w in gat_layers(cfg))


def gat_pass_k7_bound_s(cfg, n_nodes, n_edges):
    """The sum of K7's bounds over a pass's layers (bf16 projections)."""
    return sum(k7_bound_s(n_nodes, n_edges, h, w, 2)
               for _, h, w in gat_layers(cfg))
