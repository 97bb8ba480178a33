from .mtx import load_matrix_market  # noqa: F401
