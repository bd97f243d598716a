"""Train-step builders of the port."""
