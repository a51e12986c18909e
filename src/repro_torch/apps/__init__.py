from .advection import (pw_advection, pw_advection_update,  # noqa: F401
                        tracer_advection, tracer_advection_update)
