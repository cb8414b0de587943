"""EPaxos for the torch sim runtime."""
