"""One process holds every parameter: no tensor-parallel split."""


def is_split(local: int, full: int) -> bool:
    return False


def bias_on_first(b):
    return b


def reduce_from_model(x):
    return x


def copy_to_model(x):
    return x
