"""Synthetic census-income-like data with planted structure, including
an education x occupation interaction so the wide crosses carry signal
(the port's copy of the JAX zoo's model_zoo/census/data.py, row for row
in its output).  `write_dataset` writes CSV files; `write_table` puts the
same rows into a SQLite table of TEXT columns for the table reader."""

from __future__ import annotations

import csv
import os
import sqlite3

import numpy as np

from elasticdl_tpu_torch.model_zoo.census.wide_and_deep import COLUMNS

_VOCAB = {
    "workclass": [f"class_{i}" for i in range(8)],
    "education": [f"edu_{i}" for i in range(16)],
    "marital_status": [f"marital_{i}" for i in range(7)],
    "occupation": [f"occ_{i}" for i in range(14)],
    "relationship": [f"rel_{i}" for i in range(6)],
    "race": [f"race_{i}" for i in range(5)],
    "sex": ["male", "female"],
    "native_country": [f"country_{i}" for i in range(40)],
}


def synthetic_census(n: int, seed: int = 0):
    """n rows of strings, ordered as COLUMNS."""
    rng = np.random.RandomState(seed)
    planted = np.random.RandomState(11)
    cat_values = {}
    cat_weights = {}
    for col, vocab in _VOCAB.items():
        cat_values[col] = rng.randint(0, len(vocab), size=n)
        cat_weights[col] = planted.randn(len(vocab)) * 0.5
    age = rng.randint(17, 80, size=n)
    gain = np.round(rng.exponential(500, size=n), 2)
    loss_ = np.round(rng.exponential(100, size=n), 2)
    hours = rng.randint(10, 70, size=n)

    logits = (
        0.04 * (age - 40)
        + 0.0003 * gain
        + 0.03 * (hours - 40)
        + sum(cat_weights[c][cat_values[c]] for c in _VOCAB)
        # planted cross: certain education x occupation combos pay
        + 1.5 * ((cat_values["education"] + cat_values["occupation"]) % 5 == 0)
        - 0.5
    )
    prob = 1.0 / (1.0 + np.exp(-logits))
    labels = (rng.rand(n) < prob).astype(int)

    rows = []
    for i in range(n):
        row = [
            str(age[i]), str(gain[i]), str(loss_[i]), str(hours[i]),
        ] + [
            _VOCAB[c][cat_values[c][i]] for c in
            ["workclass", "education", "marital_status", "occupation",
             "relationship", "race", "sex", "native_country"]
        ] + [str(labels[i])]
        rows.append(row)
    return rows


def write_csv(path: str, rows) -> str:
    """`rows` under a COLUMNS header."""
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(COLUMNS)
        writer.writerows(rows)
    return path


def write_dataset(directory: str, n_train: int = 8192, n_val: int = 2048,
                  seed: int = 0):
    """A training and a validation CSV file, as the JAX zoo's
    write_dataset names and fills them; returns (train_dir, val_dir)."""
    train_dir = os.path.join(directory, "train")
    val_dir = os.path.join(directory, "val")
    os.makedirs(train_dir, exist_ok=True)
    os.makedirs(val_dir, exist_ok=True)
    write_csv(os.path.join(train_dir, "census-train.csv"),
              synthetic_census(n_train, seed))
    write_csv(os.path.join(val_dir, "census-val.csv"),
              synthetic_census(n_val, seed + 1))
    return train_dir, val_dir


def write_table(path: str, table: str, rows) -> str:
    """`rows` into a new SQLite table of TEXT columns named as COLUMNS;
    returns the table reader's origin, `sqlite://<path>?table=<table>`."""
    cols = ", ".join(f'"{c}" TEXT' for c in COLUMNS)
    marks = ", ".join("?" for _ in COLUMNS)
    with sqlite3.connect(path) as conn:
        conn.execute(f'CREATE TABLE "{table}" ({cols})')
        conn.executemany(f'INSERT INTO "{table}" VALUES ({marks})', rows)
    conn.close()
    return f"sqlite://{os.path.abspath(path)}?table={table}"
