// Native runtime for the k-selection framework.
//
// Two components, mirroring the reference's two compiled programs:
//
// 1. nth_element_*: the sequential oracle engine — the compiled equivalent
//    of the reference's `seq` binary (kth-problem-seq.c sort-then-index,
//    done with introselect instead of a full qsort).
//
// 2. cgm_kselect_i32: the distributed CGM weighted-median k-selection of
//    TODO-kth-problem-cgm.c:35-296, re-implemented as P forked OS processes
//    communicating through a POSIX shared-memory control block — the
//    in-tree stand-in for the MPICH runtime (libmpi.so.12) the reference
//    links. Collective correspondence:
//
//      MPI_Scatterv (:103)   -> each child copies its balanced block
//                               (:81-100 partitioning) out of the parent's
//                               copy-on-write pages into a private shard
//      MPI_Gather  (:135-136)-> per-rank slots in the control block + barrier
//      MPI_Bcast   (:168)    -> root writes the pivot slot + barrier
//      MPI_Allreduce (:190)  -> per-rank (l,e,g) slots + barrier + local sum
//      MPI_Barrier (:269)    -> pthread_barrier_t (PTHREAD_PROCESS_SHARED)
//      MPI_Gatherv (:270)    -> shared survivor arena with displacements
//                               computed from gathered counts (:245-266)
//
//    Deliberate repairs over the reference (SURVEY.md §2.3): shards stay
//    sorted and discards narrow a [lo,hi) window (the reference's VecErase
//    swap-delete scrambled order, degrading its pivots); the use-after-free
//    around the final Gatherv (:250-270) has no analogue here; counters are
//    64-bit so N > 2^31 cannot overflow (SURVEY.md §7).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <new>
#include <pthread.h>
#include <signal.h>
#include <sys/mman.h>
#include <sys/wait.h>
#include <time.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr int kMaxProcs = 64;

template <typename T>
int nth_impl(const T* data, int64_t n, int64_t k, T* out) {
  if (!data || !out || n <= 0 || k < 1 || k > n) return 1;
  std::vector<T> buf(data, data + n);
  std::nth_element(buf.begin(), buf.begin() + (k - 1), buf.end());
  *out = buf[k - 1];
  return 0;
}

double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + 1e-9 * ts.tv_nsec;
}

struct Ctrl {
  pthread_barrier_t barrier;
  int64_t meds[kMaxProcs];
  int64_t cnts[kMaxProcs];
  int64_t leg[kMaxProcs][3];
  int64_t pivot;
  int64_t surv_cnt[kMaxProcs];
  int32_t answer;
  int32_t found;
  int64_t rounds;
  double elapsed;
  int32_t error;
};

// One SPMD rank of the CGM protocol (the body of main(), TODO-…:35-296).
void cgm_rank(int r, int p, const int32_t* input, int64_t n, int64_t k,
              int64_t c, Ctrl* ctl, int32_t* arena) {
  // balanced block partition: first n%p ranks get one extra (TODO-…:81-100)
  const int64_t base = n / p, rem = n % p;
  const int64_t sz = base + (r < rem ? 1 : 0);
  const int64_t off = r * base + std::min<int64_t>(r, rem);

  double t0 = now_s();  // MPI_Wtime after generation (:76)

  std::vector<int32_t> shard(input + off, input + off + sz);  // Scatterv :103
  std::sort(shard.begin(), shard.end());                      // qsort :115

  int64_t lo = 0, hi = sz;
  int64_t kk = k;
  int64_t N = n;
  bool found = false;
  int32_t answer = 0;
  int64_t rounds = 0;
  const int64_t threshold = std::max<int64_t>(1, n / (c * p));  // :122
  // true-median pivots discard >= N/4 per round; generous safety bound, the
  // post-loop gather path is exact for any surviving window anyway
  int64_t max_rounds = 64;
  for (int64_t m = n; m; m >>= 1) max_rounds += 8;

  while (N >= threshold && rounds < max_rounds) {
    // local median of the live window; even width averages the two middles
    // with int truncation, exactly like (:126) — pivot-only, never returned
    const int64_t w = hi - lo;
    int64_t med = INT64_MIN;  // empty shard: zero weight, value ignored
    if (w > 0) {
      med = (w % 2) ? shard[lo + w / 2]
                    : ((int64_t)shard[lo + w / 2 - 1] + shard[lo + w / 2]) / 2;
    }
    ctl->meds[r] = med;  // the two MPI_Gathers (:135-136), fused as the
    ctl->cnts[r] = w;    // author's TODO (:107-112) intended
    pthread_barrier_wait(&ctl->barrier);

    if (r == 0) {  // weighted median on the root (:139-165)
      int64_t M = 0;
      bool any = false;
      for (int i = 0; i < p && !any; i++)
        if (ctl->cnts[i] > 0) { M = ctl->meds[i]; any = true; }  // fallback :163
      for (int i = 0; i < p; i++) {
        if (ctl->cnts[i] == 0) continue;
        const int64_t mi = ctl->meds[i];
        int64_t min_sum = 0, max_sum = 0;
        for (int j = 0; j < p; j++) {
          if (ctl->meds[j] < mi) min_sum += ctl->cnts[j];
          else if (ctl->meds[j] > mi) max_sum += ctl->cnts[j];
        }
        if (2 * min_sum <= N && 2 * max_sum <= N) { M = mi; break; }
      }
      ctl->pivot = M;  // MPI_Bcast (:168)
    }
    pthread_barrier_wait(&ctl->barrier);
    const int64_t M = ctl->pivot;

    // local L/E/G (:170-185) — binary searches on the sorted window instead
    // of the reference's linear sweep
    const int64_t lb =
        std::lower_bound(shard.begin() + lo, shard.begin() + hi, M) -
        shard.begin();
    const int64_t ub =
        std::upper_bound(shard.begin() + lo, shard.begin() + hi, M) -
        shard.begin();
    ctl->leg[r][0] = lb - lo;
    ctl->leg[r][1] = ub - lb;
    ctl->leg[r][2] = hi - ub;
    pthread_barrier_wait(&ctl->barrier);  // MPI_Allreduce(SUM) (:190)
    int64_t L = 0, E = 0, G = 0;
    for (int i = 0; i < p; i++) {
      L += ctl->leg[i][0];
      E += ctl->leg[i][1];
      G += ctl->leg[i][2];
    }
    rounds++;

    if (L < kk && kk <= L + E) {  // exact-hit test (:194-201)
      found = true;
      answer = (int32_t)M;  // E >= 1 ensures M is an actual element value
      break;
    }
    if (kk <= L) {  // discard >= M (:204-213), as window narrowing
      hi = lb;
      N = L;
    } else {  // discard <= M (:215-225)
      lo = ub;
      N = G;
      kk -= L + E;
    }
    // every rank computed identical (M, L, E, G, N, kk): no barrier needed
    // before the next round's per-rank slot writes (meds/cnts != leg)
  }

  if (!found) {  // remainder path (:236-280): Gatherv survivors, solve on root
    ctl->surv_cnt[r] = hi - lo;
    pthread_barrier_wait(&ctl->barrier);  // the size gather (:242)
    int64_t disp = 0, total = 0;
    for (int i = 0; i < p; i++) {
      if (i < r) disp += ctl->surv_cnt[i];
      total += ctl->surv_cnt[i];
    }
    if (hi > lo)
      std::memcpy(arena + disp, shard.data() + lo, (hi - lo) * sizeof(int32_t));
    pthread_barrier_wait(&ctl->barrier);  // MPI_Barrier + Gatherv (:269-270)
    if (r == 0) {
      if (kk < 1 || kk > total) {
        ctl->error = 3;  // invariant violation — should be impossible
      } else {
        std::nth_element(arena, arena + (kk - 1), arena + total);  // :277-279
        ctl->answer = arena[kk - 1];
      }
    }
  } else if (r == 0) {
    ctl->answer = answer;
  }
  if (r == 0) {
    ctl->found = found ? 1 : 0;
    ctl->rounds = rounds;
    ctl->elapsed = now_s() - t0;
  }
  pthread_barrier_wait(&ctl->barrier);  // all ranks done before exit
}

}  // namespace

extern "C" {

int nth_element_i32(const int32_t* d, int64_t n, int64_t k, int32_t* o) {
  return nth_impl(d, n, k, o);
}
int nth_element_i64(const int64_t* d, int64_t n, int64_t k, int64_t* o) {
  return nth_impl(d, n, k, o);
}
int nth_element_f32(const float* d, int64_t n, int64_t k, float* o) {
  return nth_impl(d, n, k, o);
}
int nth_element_f64(const double* d, int64_t n, int64_t k, double* o) {
  return nth_impl(d, n, k, o);
}

// Distributed CGM k-selection over num_procs forked ranks.
// Returns 0 on success; 1 bad args (mirrors the world_size >= 2 abort at
// TODO-…:56-59), 2 runtime failure, 3 internal invariant violation.
int cgm_kselect_i32(const int32_t* data, int64_t n, int64_t k, int num_procs,
                    int64_t c, int32_t* answer, int64_t* rounds,
                    double* elapsed, int32_t* found_early) {
  if (!data || !answer || n <= 0 || k < 1 || k > n) return 1;
  if (num_procs < 2 || num_procs > kMaxProcs) return 1;  // MPI_Abort :56-59
  if (c < 1) return 1;

  const size_t arena_bytes = sizeof(Ctrl) + (size_t)n * sizeof(int32_t);
  void* shm = mmap(nullptr, arena_bytes, PROT_READ | PROT_WRITE,
                   MAP_SHARED | MAP_ANONYMOUS, -1, 0);
  if (shm == MAP_FAILED) return 2;
  Ctrl* ctl = new (shm) Ctrl();
  int32_t* arena = (int32_t*)((char*)shm + sizeof(Ctrl));
  std::memset(ctl, 0, sizeof(Ctrl));

  pthread_barrierattr_t attr;
  pthread_barrierattr_init(&attr);
  pthread_barrierattr_setpshared(&attr, PTHREAD_PROCESS_SHARED);
  if (pthread_barrier_init(&ctl->barrier, &attr, num_procs) != 0) {
    munmap(shm, arena_bytes);
    return 2;
  }
  pthread_barrierattr_destroy(&attr);

  std::vector<pid_t> pids;
  int rc = 0;
  for (int r = 0; r < num_procs; r++) {
    pid_t pid = fork();
    if (pid < 0) {
      rc = 2;  // fork failed: kill and reap already-spawned ranks
      for (pid_t q : pids) kill(q, SIGKILL);
      for (pid_t q : pids) waitpid(q, nullptr, 0);
      break;
    }
    if (pid == 0) {
      cgm_rank(r, num_procs, data, n, k, c, ctl, arena);
      _exit(0);
    }
    pids.push_back(pid);
  }
  if (rc == 0) {
    // Reap with WNOHANG polling (never waitpid(-1): the hosting process may
    // own unrelated children). If any rank dies abnormally mid-protocol the
    // survivors are stuck in pthread_barrier_wait forever — kill the rest so
    // the call returns rc=2 instead of hanging in waitpid.
    std::vector<bool> done(pids.size(), false);
    size_t remaining = pids.size();
    bool killed = false;
    while (remaining > 0) {
      bool progressed = false;
      for (size_t i = 0; i < pids.size(); i++) {
        if (done[i]) continue;
        int status = 0;
        const pid_t w = waitpid(pids[i], &status, WNOHANG);
        if (w == 0) continue;
        done[i] = true;
        remaining--;
        progressed = true;
        if (w < 0 || !WIFEXITED(status) || WEXITSTATUS(status) != 0) rc = 2;
      }
      if (rc != 0 && !killed) {
        killed = true;
        for (size_t i = 0; i < pids.size(); i++)
          if (!done[i]) kill(pids[i], SIGKILL);
      }
      if (remaining > 0 && !progressed) usleep(1000);
    }
  }
  if (rc == 0 && ctl->error != 0) rc = ctl->error;
  if (rc == 0) {
    *answer = ctl->answer;
    if (rounds) *rounds = ctl->rounds;
    if (elapsed) *elapsed = ctl->elapsed;
    if (found_early) *found_early = ctl->found;
  }
  pthread_barrier_destroy(&ctl->barrier);
  munmap(shm, arena_bytes);
  return rc;
}

}  // extern "C"
