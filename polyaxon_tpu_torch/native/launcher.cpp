// polyaxon-launcher (PyTorch port): native multi-process gang supervisor,
// an own copy of polyaxon_tpu/native/launcher.cpp.
//
// It launches the worker processes of a JAXJob on this host, one per
// device, injects torch.distributed's rendezvous environment (the master
// address and port, the rank, the world size and the local rank), and
// supervises them with GANG semantics: collectives cannot survive a lost
// member, so one failure tears down and restarts the whole gang.
//
// Usage:
//   polyaxon-launcher [--num-workers N] [--coordinator HOST:PORT]
//                     [--max-restarts R] [--timeout SECONDS]
//                     [--env KEY=VALUE]... -- command args...
//
// Per-worker injected env (--coordinator HOST:PORT is split in two):
//   MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE
//   LOCAL_RANK (the worker's index on this host: its device)
//   POLYAXON_WORKER_ID (same as RANK)
// Status stream: one JSON line per event on stdout:
//   {"event":"gang_start","attempt":0,"workers":4}
//   {"event":"worker_exit","worker":2,"pid":123,"code":1}
//   {"event":"gang_restart","attempt":1}
//   {"event":"gang_done","code":0}
//
// Exit code: 0 all workers succeeded; first failing worker's code after
// retries are exhausted; 124 on timeout; 143 on SIGTERM.

#include <cerrno>
#include <chrono>
#include <cstdarg>
#include <csignal>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <sys/types.h>
#include <sys/wait.h>
#include <unistd.h>

namespace {

volatile sig_atomic_t g_stop_signal = 0;

void handle_stop(int sig) { g_stop_signal = sig; }

struct Options {
  int num_workers = 1;
  std::string coordinator = "127.0.0.1:12355";
  int max_restarts = 0;
  long timeout_s = 0;  // 0 = none
  // multi-host: this host's global rank offset and the gang-wide process
  // count. --process-id-offset accepts a number or "env:VAR" (e.g.
  // env:JOB_COMPLETION_INDEX on an indexed k8s Job); --process-id-base is
  // a constant added on top (multi-slice jobs: base = slice_id *
  // hosts_per_slice, offset = within-slice completion index);
  // --total-processes defaults to num_workers (single-host).
  std::string process_id_offset = "0";
  int process_id_base = 0;
  int total_processes = 0;
  std::vector<std::string> extra_env;
  std::vector<char*> command;
};

int resolve_offset(const Options& opt) {
  const std::string& s = opt.process_id_offset;
  if (s.rfind("env:", 0) == 0) {
    const char* v = getenv(s.c_str() + 4);
    return opt.process_id_base + (v ? std::atoi(v) : 0);
  }
  return opt.process_id_base + std::atoi(s.c_str());
}

void usage(const char* argv0) {
  std::fprintf(stderr,
               "usage: %s [--num-workers N] [--coordinator HOST:PORT] "
               "[--max-restarts R] [--timeout SECONDS] [--env K=V]... "
               "-- command args...\n",
               argv0);
  std::exit(2);
}

Options parse_args(int argc, char** argv) {
  Options opt;
  int i = 1;
  for (; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&]() -> const char* {
      if (i + 1 >= argc) usage(argv[0]);
      return argv[++i];
    };
    if (a == "--num-workers") {
      opt.num_workers = std::atoi(next());
    } else if (a == "--coordinator") {
      opt.coordinator = next();
    } else if (a == "--max-restarts") {
      opt.max_restarts = std::atoi(next());
    } else if (a == "--timeout") {
      opt.timeout_s = std::atol(next());
    } else if (a == "--process-id-offset") {
      opt.process_id_offset = next();
    } else if (a == "--process-id-base") {
      opt.process_id_base = std::atoi(next());
    } else if (a == "--total-processes") {
      opt.total_processes = std::atoi(next());
    } else if (a == "--env") {
      opt.extra_env.push_back(next());
    } else if (a == "--") {
      ++i;
      break;
    } else {
      usage(argv[0]);
    }
  }
  for (; i < argc; ++i) opt.command.push_back(argv[i]);
  if (opt.command.empty() || opt.num_workers < 1) usage(argv[0]);
  opt.command.push_back(nullptr);
  return opt;
}

void emit(const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::vfprintf(stdout, fmt, ap);
  va_end(ap);
  std::fputc('\n', stdout);
  std::fflush(stdout);
}

pid_t spawn_worker(const Options& opt, int worker_id) {
  pid_t pid = fork();
  if (pid < 0) {
    std::perror("fork");
    return -1;
  }
  if (pid == 0) {
    // child: own process group so the supervisor can signal cleanly
    setpgid(0, 0);
    char buf[64];
    int global_id = resolve_offset(opt) + worker_id;
    std::snprintf(buf, sizeof buf, "%d", global_id);
    setenv("RANK", buf, 1);
    setenv("POLYAXON_WORKER_ID", buf, 1);
    std::snprintf(buf, sizeof buf, "%d", worker_id);
    setenv("LOCAL_RANK", buf, 1);
    int total =
        opt.total_processes > 0 ? opt.total_processes : opt.num_workers;
    std::snprintf(buf, sizeof buf, "%d", total);
    setenv("WORLD_SIZE", buf, 1);
    const std::string& coord = opt.coordinator;
    auto colon = coord.rfind(':');
    setenv("MASTER_ADDR", coord.substr(0, colon).c_str(), 1);
    setenv("MASTER_PORT",
           colon == std::string::npos ? "12355" : coord.c_str() + colon + 1, 1);
    for (const auto& kv : opt.extra_env) {
      auto eq = kv.find('=');
      if (eq != std::string::npos) {
        setenv(kv.substr(0, eq).c_str(), kv.substr(eq + 1).c_str(), 1);
      }
    }
    execvp(opt.command[0], opt.command.data());
    std::perror("execvp");
    _exit(127);
  }
  return pid;
}

void kill_gang(std::vector<pid_t>& pids, int sig) {
  for (pid_t pid : pids) {
    if (pid > 0) kill(-pid, sig);  // negative: whole process group
  }
}

// Reap everything still alive; 5s grace from SIGTERM to SIGKILL.
void drain_gang(std::vector<pid_t>& pids) {
  kill_gang(pids, SIGTERM);
  auto deadline = std::chrono::steady_clock::now() + std::chrono::seconds(5);
  for (pid_t& pid : pids) {
    if (pid <= 0) continue;
    int status;
    while (true) {
      pid_t r = waitpid(pid, &status, WNOHANG);
      if (r == pid || (r < 0 && errno == ECHILD)) break;
      if (std::chrono::steady_clock::now() > deadline) {
        kill(-pid, SIGKILL);
        waitpid(pid, &status, 0);
        break;
      }
      usleep(50 * 1000);
    }
    pid = -1;
  }
}

}  // namespace

int main(int argc, char** argv) {
  Options opt = parse_args(argc, argv);
  std::signal(SIGTERM, handle_stop);
  std::signal(SIGINT, handle_stop);

  auto start = std::chrono::steady_clock::now();
  int attempt = 0;
  int final_code = 0;

  while (true) {
    emit("{\"event\":\"gang_start\",\"attempt\":%d,\"workers\":%d}", attempt,
         opt.num_workers);
    std::vector<pid_t> pids(opt.num_workers, -1);
    for (int w = 0; w < opt.num_workers; ++w) {
      pids[w] = spawn_worker(opt, w);
      if (pids[w] < 0) {
        drain_gang(pids);
        return 1;
      }
      emit("{\"event\":\"worker_start\",\"worker\":%d,\"pid\":%d}", w,
           (int)pids[w]);
    }

    int alive = opt.num_workers;
    int gang_code = 0;
    while (alive > 0) {
      if (g_stop_signal) {
        emit("{\"event\":\"stopped\",\"signal\":%d}", (int)g_stop_signal);
        drain_gang(pids);
        return 143;
      }
      if (opt.timeout_s > 0) {
        auto elapsed = std::chrono::duration_cast<std::chrono::seconds>(
                           std::chrono::steady_clock::now() - start)
                           .count();
        if (elapsed > opt.timeout_s) {
          emit("{\"event\":\"timeout\",\"seconds\":%ld}", opt.timeout_s);
          drain_gang(pids);
          return 124;
        }
      }
      int status;
      pid_t r = waitpid(-1, &status, WNOHANG);
      if (r == 0) {
        usleep(100 * 1000);
        continue;
      }
      if (r < 0) break;  // no children left
      int worker = -1;
      for (int w = 0; w < opt.num_workers; ++w) {
        if (pids[w] == r) worker = w;
      }
      if (worker < 0) continue;
      int code = WIFEXITED(status)   ? WEXITSTATUS(status)
                 : WIFSIGNALED(status) ? 128 + WTERMSIG(status)
                                       : 1;
      emit("{\"event\":\"worker_exit\",\"worker\":%d,\"pid\":%d,\"code\":%d}",
           worker, (int)r, code);
      pids[worker] = -1;
      --alive;
      if (code != 0) {
        // gang semantics: one member down -> the collective is broken;
        // tear down the rest and decide on restart
        gang_code = code;
        drain_gang(pids);
        alive = 0;
      }
    }

    if (gang_code == 0) {
      emit("{\"event\":\"gang_done\",\"code\":0}");
      return 0;
    }
    final_code = gang_code;
    if (attempt >= opt.max_restarts) break;
    ++attempt;
    emit("{\"event\":\"gang_restart\",\"attempt\":%d}", attempt);
  }

  emit("{\"event\":\"gang_done\",\"code\":%d}", final_code);
  return final_code;
}
