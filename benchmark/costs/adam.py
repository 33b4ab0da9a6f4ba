"""A dense Adam or AdamW step over P float32 parameters: read the
parameter, its gradient and both moments, write the parameter and both
moments: 7 x 4 bytes a parameter (the decay and the bias corrections
need no further traffic)."""


def cost(params: int):
    return 12.0 * params, 28.0 * params
