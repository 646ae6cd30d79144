// Native stack dumps of live workers (reference capability:
// dashboard/modules/reporter/reporter_agent.py shells out to py-spy for
// stacks of ANY worker, including ones wedged inside C++/CUDA; here the
// worker carries its own dumper).
//
// stack_dump_install(path) registers a C-LEVEL SIGUSR2 handler that
// writes the RECEIVING thread's native backtrace to `path`.  A Python
// signal handler only runs between bytecodes — a thread stuck inside an
// XLA dispatch or a native arena never reaches one; a C handler
// interrupts blocking C code directly.  The raylet's dump endpoint
// directs the signal at every thread (tgkill), so each thread appends
// its own frames.
//
// Async-signal-safety: backtrace(3)/backtrace_symbols_fd(3) are the
// sanctioned not-quite-safe workhorses of every production crash
// reporter (the first backtrace call is made at install time so libgcc's
// unwinder state is initialized before any signal arrives).

#include <execinfo.h>
#include <fcntl.h>
#include <signal.h>
#include <stdio.h>
#include <string.h>
#include <sys/syscall.h>
#include <unistd.h>

static int g_fd = -1;

static void handler(int sig, siginfo_t* info, void* ctx) {
  (void)sig;
  (void)info;
  (void)ctx;
  if (g_fd < 0) return;
  void* buf[64];
  int n = backtrace(buf, 64);
  char head[96];
  long tid = (long)syscall(SYS_gettid);
  int len = snprintf(head, sizeof(head), "=== native stack tid %ld ===\n", tid);
  if (len > 0) {
    ssize_t r = write(g_fd, head, (size_t)len);
    (void)r;
  }
  backtrace_symbols_fd(buf, n, g_fd);
  static const char kEnd[] = "=== end ===\n";
  ssize_t r = write(g_fd, kEnd, sizeof(kEnd) - 1);
  (void)r;
}

extern "C" int stack_dump_install(const char* path) {
  // pre-initialize the unwinder outside signal context
  void* warm[4];
  backtrace(warm, 4);
  int fd = open(path, O_WRONLY | O_CREAT | O_APPEND | O_NOFOLLOW | O_CLOEXEC,
                0600);
  if (fd < 0) return -1;
  g_fd = fd;
  struct sigaction sa;
  memset(&sa, 0, sizeof(sa));
  sa.sa_sigaction = handler;
  sa.sa_flags = SA_SIGINFO | SA_RESTART;  // wedged syscalls resume, unharmed
  sigemptyset(&sa.sa_mask);
  if (sigaction(SIGUSR2, &sa, nullptr) != 0) return -2;
  return 0;
}
