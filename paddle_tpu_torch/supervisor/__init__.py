"""Supervision the serving engine needs: the step watchdog (the port's own
copy of ``paddle_tpu/supervisor/watchdog.py``)."""
