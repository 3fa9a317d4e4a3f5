"""Host-side (numpy) graph layer, model and trainers of the port."""
