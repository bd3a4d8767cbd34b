"""The simulated network: flight pool (`tpu`) and edge channels (`static`)."""
