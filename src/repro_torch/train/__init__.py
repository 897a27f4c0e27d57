"""Training substrate of the port: Adam with its schedules and clipping
(``optimizer``) and pytree checkpoints (``checkpoint``)."""
