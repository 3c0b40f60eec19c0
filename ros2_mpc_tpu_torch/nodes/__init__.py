from .bus import MessageBus
from .launch import SimStack, build_sim_stack, run_sim_stack
from .sim import Simulator

__all__ = ["MessageBus", "SimStack", "build_sim_stack", "run_sim_stack", "Simulator"]
