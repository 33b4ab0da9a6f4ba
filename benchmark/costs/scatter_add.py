"""The embedding backward's scatter-add of N (N, D) float32 gradient
rows into a table at int32 ids: the ids and the gradient rows read once,
the U rows the ids touch read and written once; one add per gradient
element.  U is what these inputs touch, counted from the data."""


def cost(n: int, dim: int, touched: int):
    return float(n * dim), float(n * 4 + n * dim * 4 + 2 * touched * dim * 4)
