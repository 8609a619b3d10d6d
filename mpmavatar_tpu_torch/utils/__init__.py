"""Host-side helpers of the port: training losses, schedules, mesh and
point-cloud IO, checkpoints, logging, profiling, a mesh preview and misc
host utilities."""
