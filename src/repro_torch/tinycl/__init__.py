"""repro_torch.tinycl — the Tiny-OpenCL host API, under its own name.

The paper's §IV contribution is Tiny-OpenCL: a lightweight but *real*
OpenCL host API — programs, kernel objects, buffer objects, command queues,
events, and explicit host<->e-GPU data-movement commands over the shared
X-HEEP memory.  This façade collects the ported host surface in one
namespace; everything re-exports from ``repro_torch.core`` (there is
exactly one implementation).

OpenCL -> TinyCL mapping::

    clCreateContext                     Context(Device(config), torch_device)
    clCreateCommandQueue                CommandQueue(ctx, ...)
      CL_QUEUE_OUT_OF_ORDER_EXEC_MODE     out_of_order=True
    clCreateBuffer                      ctx.create_buffer(data, flags,
      CL_MEM_USE_HOST_PTR                 use_host_ptr=True / copy=False)
                                        (a tensor on the context's device is
                                         adopted, anything else copied there;
                                         only such a tensor can be aliased)
    clCreateProgramWithBuiltInKernels   Program.build(config)
    clCreateKernel                      program.create_kernel(name, **variant)
    clCreateKernelsInProgram            program.create_kernels()
    clGetKernelArgInfo                  kernel.arg_info
    clSetKernelArg                      kernel.set_arg(i, v) / kernel.set_args
    clEnqueueNDRangeKernel              queue.enqueue_kernel(kernel, ndr)
                                        (queue.enqueue_nd_range for
                                         call-site args)
    clEnqueueWriteBuffer                queue.enqueue_write_buffer(buf, src)
    clEnqueueReadBuffer                 queue.enqueue_read_buffer(buf)
    clEnqueueCopyBuffer                 queue.enqueue_copy_buffer(src, dst)
    clEnqueueMarkerWithWaitList         queue.enqueue_marker(wait_events)
    clEnqueueBarrierWithWaitList        queue.enqueue_barrier(wait_events)
    event_wait_list                     wait_events=[...] on every enqueue
    clFlush / clFinish                  queue.flush() / queue.finish()
    clRetainEvent / clReleaseEvent      event.retain() / event.release()
    clWaitForEvents                     event.wait()

Beyond OpenCL: ``queue.capture()`` records commands into a
:class:`CommandGraph` replayed as one launch (``graph.join(queue)`` adds a
second queue's commands), and every event carries the analytic machine
model's :class:`PhaseBreakdown` / energy for its device configuration.
"""

from ..core.device import (EGPU_4T, EGPU_8T, EGPU_16T, HOST, PRESETS,
                           EGPUConfig, KernelKnobs)
from ..core.machine import PhaseBreakdown, WorkCounts, transfer_time
from ..core.ndrange import NDRange
from ..core.program import (BUILTIN_FAMILIES, REGISTRY, KernelRegistry,
                            Program, kernel_family)
from ..core.runtime import (ArgInfo, Buffer, CommandGraph, CommandQueue,
                            Context, Device, Event, GraphBuffer, Kernel)
from ..core.scheduler import optimal_ndrange

__all__ = [
    "EGPU_4T", "EGPU_8T", "EGPU_16T", "HOST", "PRESETS", "EGPUConfig",
    "KernelKnobs",
    "PhaseBreakdown", "WorkCounts", "transfer_time",
    "NDRange", "optimal_ndrange",
    "BUILTIN_FAMILIES", "REGISTRY", "KernelRegistry", "Program",
    "kernel_family",
    "ArgInfo", "Buffer", "CommandGraph", "CommandQueue", "Context", "Device",
    "Event", "GraphBuffer", "Kernel",
]
