"""Host control plane: scheduler, pager, transport, descriptor, engine."""
