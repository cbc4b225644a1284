"""Cells cut to a size that a CPU test can run in seconds: the same
files, with the configuration's scale and the traffic's mixture made
small.  The Wide&Deep fit learns fast enough (a larger rate, more
epochs, a table the rows can be told apart by) that a fit which stops
learning after its first epoch shows in its later losses.  Used only by
the tests."""

SIZES = {
    "wd_criteo.fit": {"rows": 4096, "vocab_per_field": 1000,
                      "hidden_units": [16, 8], "embedding_dim": 4,
                      "global_batch_size": 512, "max_iter": 6,
                      "learning_rate": 0.05},
    "kmeans_sift1m.fit": {"n": 4096, "d": 8, "k": 16, "max_iter": 3},
}
DATA = {"kmeans_sift1m.fit": {"true_centers": 64}}


def shrink(spec: dict) -> None:
    name = spec["cell"]["name"]
    spec["config"].update(SIZES[name])
    spec["traffic"]["data"].update(DATA.get(name, {}))


def argv(cell: str, seed: int = 3_000_000_001, seconds: float = 0.5,
         trace: int = 0) -> list:
    return ["--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
