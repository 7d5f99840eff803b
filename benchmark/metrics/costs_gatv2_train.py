"""FLOP and byte counts of a GATv2 training step, by ``costs.py``'s rules:
a multiply and an add are two operations, only the valid (unpadded) rows
and edges count, and a backward pass counts twice its forward, so a step
is three forwards. ``counts`` is a step's raw sampled counts as the step
returns them: [num_nodes/0 .. num_nodes/L, num_edges/0 .. num_edges/L-1]
(block l: num_nodes/l srcs, num_nodes/l+1 dsts, num_edges/l edges)."""
import os

from bmk.spec import load_module

costs = load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "costs.py"), "bench_costs")

BF16_FLOPS = costs.BF16_FLOPS
HBM_BYTES_PER_S = costs.HBM_BYTES_PER_S
# K5's route (the port's ops/segment.py): rows of at least 2^15 edges and
# a width that is a multiple of 128 and at least 512
K5_MIN_ROWS, K5_MIN_FEATS = 1 << 15, 512


def gat_layer_flops(n_src, n_edges, d_in, heads, width):
    """One GATv2 layer on a block, forward: the projection of the srcs
    (2 n_src d_in H O); the logits, the src and dst rows added, the leaky
    ReLU and the product with attn summed over O (4 E H O); the edge
    softmax (~5 E H: the max, the shift, the exponent, the sum and the
    division); the messages a * f_src and their sum per dst (2 E H O)."""
    ho = heads * width
    return (2 * n_src * d_in * ho + 4 * n_edges * ho + 5 * n_edges * heads
            + 2 * n_edges * ho)


def gat_step_flops(cfg, counts):
    """A training step of the configuration's GATv2: 3 x the forward."""
    L = cfg["model"]["layers"]
    return 3 * sum(gat_layer_flops(counts[l], counts[L + 1 + l], d_in, h, w)
                   for l, (d_in, h, w) in enumerate(costs.gat_layers(cfg)))


def k5_step_bytes(cfg, counts):
    """K5's compulsory bytes in one step: at each layer whose [E, H O]
    rows take K5's route, its three launch sites, the messages summed per
    dst and the dst-row gather's backward (sorted, into the dsts) and the
    src-row gather's backward (into the srcs), each reading E rows of
    H O bf16 and E ids of 4 bytes and writing its valid output rows in
    bf16. A layer is counted where its valid edges alone reach K5's
    route; where only the padded capacity does, K5 ran and is not
    counted, which can only lower the share."""
    L = cfg["model"]["layers"]
    out = 0
    for l, (_, h, w) in enumerate(costs.gat_layers(cfg)):
        ho, e = h * w, counts[L + 1 + l]
        if ho % 128 or ho < K5_MIN_FEATS or e < K5_MIN_ROWS:
            continue
        n_src, n_dst = counts[l], counts[l + 1]
        out += 3 * e * (ho * 2 + 4) + (2 * n_dst + n_src) * ho * 2
    return out
