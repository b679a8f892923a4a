"""Tiny overrides of the cells for CPU runs of the whole harness: the
published widths cut to a few channels, images of 64-128 px."""

TINY = {"hidden_dim": 32, "nheads": 4, "enc_layers": 1, "dec_layers": 2, "dim_feedforward": 64}
SERVE_TRAFFIC = {"heights": [64, 96], "widths": [64, 96], "per_size": 2, "bucket": [96, 96]}
SERVE_LIMITS = {"logit_gap": 1e-4, "box_gap": 1e-4, "var_gap": 1e-4, "served_mismatch": 0}

CELLS = {
    "s2_serve_b32": {
        "model": {**TINY, "num_query_position": 64},
        "traffic": {**SERVE_TRAFFIC, "requests_per_call": 4},
        "cell": {"warmup_calls": 1, "profiled_calls": 1,
                 "check": {"sample_calls": 2, "limits": SERVE_LIMITS}}},
    "s2_serve_b1": {
        "model": {**TINY, "num_query_position": 64},
        "traffic": SERVE_TRAFFIC,
        "cell": {"warmup_calls": 1, "profiled_calls": 2,
                 "check": {"sample_calls": 3, "limits": SERVE_LIMITS}}},
    "s1_pseudo_fsc147": {
        "model": TINY,
        "traffic": {"height": 64, "widths": [64, 96, 128], "block": 16, "dataset_images": 16,
                    "lognormal_median": 5, "min_points": 2, "max_points": 40,
                    "warm_widths": [64, 96, 128], "warm_counts": [4, 40]},
        # one bucket: the 16 images of a block fill two batches of 8
        "cell": {"buckets": [[64, 128]], "num_workers": 0, "blocks_per_second": 1.0,
                 "check": {"sample_images": 3, "tiers": [8, 40],
                           "limits": {"layout_mismatch": 0, "wh_gap_px": 1e-3}}}},
}
