from .solver import MPMSolver, validate_state  # noqa: F401
