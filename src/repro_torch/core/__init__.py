"""InfAdapter control plane: profiles, Eq. 1 objective and solvers,
dispatcher, rate monitor, forecaster and the controller (host-only copies
of the reference package's modules)."""
