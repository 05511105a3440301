from .supervisor import Supervisor, heartbeat_age, touch_heartbeat

__all__ = ["Supervisor", "heartbeat_age", "touch_heartbeat"]
