"""Host-side helpers of the port (training losses, schedules)."""
