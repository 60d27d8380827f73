// A std::terminate handler that names the thread that calls it and prints
// that thread's native stack before aborting: loaded with ctypes and
// installed by `install()` (scripts/torch_leg_teardown.py).
#include <cxxabi.h>
#include <execinfo.h>
#include <pthread.h>
#include <sys/syscall.h>
#include <unistd.h>

#include <cstdio>
#include <cstdlib>
#include <exception>
#include <typeinfo>

static void handler() {
  char name[64] = {0};
  pthread_getname_np(pthread_self(), name, sizeof name);
  std::type_info* t = abi::__cxa_current_exception_type();
  fprintf(stderr, "terminate_probe: tid=%ld pid=%d thread=%s exception=%s\n",
          (long)syscall(SYS_gettid), (int)getpid(), name, t ? t->name() : "none");
  void* frames[64];
  backtrace_symbols_fd(frames, backtrace(frames, 64), 2);
  fflush(stderr);
  abort();
}

extern "C" void install() { std::set_terminate(handler); }
