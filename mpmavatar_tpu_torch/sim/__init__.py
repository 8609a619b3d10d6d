from .solver import (MPMSolver, SimTransform, cfl_dt,  # noqa: F401
                     export_particle_cov, reset_density, set_E_nu,
                     set_parameters_dict, set_parameters_in_box,
                     update_cov, validate_state)
