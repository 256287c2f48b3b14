"""Multi-tenant serving: continuous batching over the ECI-managed pool."""
