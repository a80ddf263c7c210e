// rtsat — a small CDCL SAT solver used as the native core of the framework's
// SMT backend (round_tpu.verify.solver).
//
// Role parity with the reference (PSync): the reference discharges SMT
// queries by piping SMT-LIB to an external C++ solver binary (z3/cvc4,
// utils/SmtSolver.scala:14-26).  This build has no external solver, so the
// framework ships its own native core: the Python side lowers ground
// first-order queries to CNF (Tseitin) plus theory checking (EUF congruence
// closure + linear integer arithmetic) and drives this binary over a pipe
// with DIMACS in / model or UNSAT out.
//
// Features: two-watched-literal propagation, first-UIP clause learning,
// VSIDS-style activity with decay, Luby restarts, learned-clause reduction.
//
// Protocol (batch):
//   stdin:  DIMACS CNF ("p cnf <nvars> <nclauses>", clauses 0-terminated;
//           lines starting with 'c' ignored)
//   stdout: "s SATISFIABLE\nv <lit>* 0\n"  or  "s UNSATISFIABLE\n"
// Exit code: 10 sat, 20 unsat (minisat convention).
//
// Protocol (incremental, `rtsat -i`) — the DPLL(T) driver in
// round_tpu.verify.solver keeps one process per query and feeds theory
// blocking clauses between solves, so learned clauses/activities persist
// instead of re-solving the CNF from scratch each round:
//   "p cnf <n> <m>"  init (once), then <m> clause lines
//   "s"              solve; replies "r sat\nv <lit>* 0\n" or "r unsat\n"
//   "a <lit>* 0"     add a clause at level 0
//   "q"              quit

#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

typedef int Lit;  // +v / -v, 1-based DIMACS style

struct Clause {
  std::vector<Lit> lits;
  bool learned;
  double activity;
};

struct Solver {
  int nvars = 0;
  std::vector<Clause> clauses;
  // watches[lit-index] -> clause indices; lit index: 2*v + (sign?1:0)
  std::vector<std::vector<int>> watches;
  std::vector<signed char> assigns;  // 0 unset, +1 true, -1 false (per var)
  std::vector<int> level;            // decision level per var
  std::vector<int> reason;           // clause index or -1, per var
  std::vector<Lit> trail;
  std::vector<int> trail_lim;        // trail index at each decision level
  std::vector<double> activity;      // per var
  double var_inc = 1.0;
  double cla_inc = 1.0;
  std::vector<char> seen;
  size_t qhead = 0;
  long conflicts = 0;

  static int widx(Lit l) { return 2 * std::abs(l) + (l < 0 ? 1 : 0); }

  void init(int n) {
    nvars = n;
    watches.assign(2 * n + 2, {});
    assigns.assign(n + 1, 0);
    level.assign(n + 1, 0);
    reason.assign(n + 1, -1);
    activity.assign(n + 1, 0.0);
    seen.assign(n + 1, 0);
  }

  signed char value(Lit l) const {
    signed char a = assigns[std::abs(l)];
    return l > 0 ? a : (signed char)(-a);
  }

  int decision_level() const { return (int)trail_lim.size(); }

  void enqueue(Lit l, int why) {
    int v = std::abs(l);
    assigns[v] = l > 0 ? 1 : -1;
    level[v] = decision_level();
    reason[v] = why;
    trail.push_back(l);
  }

  bool add_clause(std::vector<Lit> ls, bool learned) {
    if (!learned) {
      // top-level simplification: dedup, drop clauses with both polarities
      std::vector<Lit> out;
      for (Lit l : ls) {
        bool dup = false, taut = false;
        for (Lit o : out) {
          if (o == l) dup = true;
          if (o == -l) taut = true;
        }
        if (taut) return true;
        if (!dup && value(l) != -1) {
          if (value(l) == 1) return true;  // already satisfied at level 0
          out.push_back(l);
        }
      }
      ls.swap(out);
    }
    if (ls.empty()) return false;  // conflict at level 0
    if (ls.size() == 1) {
      if (value(ls[0]) == -1) return false;
      if (value(ls[0]) == 0) enqueue(ls[0], -1);
      return true;
    }
    int ci = (int)clauses.size();
    clauses.push_back({std::move(ls), learned, 0.0});
    watches[widx(clauses[ci].lits[0])].push_back(ci);
    watches[widx(clauses[ci].lits[1])].push_back(ci);
    return true;
  }

  // returns conflicting clause index or -1
  int propagate() {
    while (qhead < trail.size()) {
      Lit p = trail[qhead++];  // p is true; visit clauses watching -p
      std::vector<int>& ws = watches[widx(-p)];
      size_t i = 0, j = 0;
      int confl = -1;
      for (; i < ws.size(); ++i) {
        int ci = ws[i];
        Clause& c = clauses[ci];
        // ensure c.lits[0] is the other watch
        if (c.lits[0] == -p) std::swap(c.lits[0], c.lits[1]);
        if (value(c.lits[0]) == 1) {
          ws[j++] = ci;
          continue;
        }
        // find a new literal to watch
        bool found = false;
        for (size_t k = 2; k < c.lits.size(); ++k) {
          if (value(c.lits[k]) != -1) {
            std::swap(c.lits[1], c.lits[k]);
            watches[widx(c.lits[1])].push_back(ci);
            found = true;
            break;
          }
        }
        if (found) continue;  // moved to another watch list
        ws[j++] = ci;
        if (value(c.lits[0]) == -1) {
          confl = ci;
          ++i;
          for (; i < ws.size(); ++i) ws[j++] = ws[i];
          break;
        }
        enqueue(c.lits[0], ci);
      }
      ws.resize(j);
      if (confl != -1) return confl;
    }
    return -1;
  }

  void bump_var(int v) {
    activity[v] += var_inc;
    if (activity[v] > 1e100) {
      for (int x = 1; x <= nvars; ++x) activity[x] *= 1e-100;
      var_inc *= 1e-100;
    }
  }

  void analyze(int confl, std::vector<Lit>& learnt, int& bt_level) {
    learnt.clear();
    learnt.push_back(0);  // placeholder for the asserting literal
    int counter = 0;
    Lit p = 0;
    int idx = (int)trail.size() - 1;
    do {
      Clause& c = clauses[confl];
      for (size_t k = (p == 0 ? 0 : 1); k < c.lits.size(); ++k) {
        Lit q = c.lits[k];
        int v = std::abs(q);
        if (!seen[v] && level[v] > 0) {
          seen[v] = 1;
          bump_var(v);
          if (level[v] == decision_level())
            ++counter;
          else
            learnt.push_back(q);
        }
      }
      // pick next literal from trail
      while (!seen[std::abs(trail[idx])]) --idx;
      p = trail[idx];
      confl = reason[std::abs(p)];
      seen[std::abs(p)] = 0;
      --counter;
    } while (counter > 0);
    learnt[0] = -p;
    // find backtrack level
    bt_level = 0;
    if (learnt.size() > 1) {
      size_t maxi = 1;
      for (size_t k = 2; k < learnt.size(); ++k)
        if (level[std::abs(learnt[k])] > level[std::abs(learnt[maxi])]) maxi = k;
      std::swap(learnt[1], learnt[maxi]);
      bt_level = level[std::abs(learnt[1])];
    }
    for (Lit l : learnt) seen[std::abs(l)] = 0;
  }

  void backtrack(int lvl) {
    if (decision_level() <= lvl) return;
    int lim = trail_lim[lvl];
    for (int i = (int)trail.size() - 1; i >= lim; --i)
      assigns[std::abs(trail[i])] = 0;
    trail.resize(lim);
    trail_lim.resize(lvl);
    qhead = trail.size();
  }

  int pick_branch() {
    int best = 0;
    double best_a = -1.0;
    for (int v = 1; v <= nvars; ++v)
      if (assigns[v] == 0 && activity[v] > best_a) {
        best = v;
        best_a = activity[v];
      }
    return best;
  }

  void reduce_learned() {
    // drop half of the learned clauses with lowest activity (not locked)
    std::vector<int> order;
    for (int i = 0; i < (int)clauses.size(); ++i)
      if (clauses[i].learned && !clauses[i].lits.empty())  // skip tombstones
        order.push_back(i);
    if (order.size() < 2000) return;
    // simple partial sort by activity
    std::sort(order.begin(), order.end(), [&](int a, int b) {
      return clauses[a].activity < clauses[b].activity;
    });
    std::vector<char> drop(clauses.size(), 0);
    for (size_t i = 0; i < order.size() / 2; ++i) {
      int ci = order[i];
      bool locked = false;
      for (Lit l : clauses[ci].lits)
        if (reason[std::abs(l)] == ci && value(l) == 1) locked = true;
      if (!locked && clauses[ci].lits.size() > 2) drop[ci] = 1;
    }
    for (auto& wl : watches) {
      size_t j = 0;
      for (size_t i = 0; i < wl.size(); ++i)
        if (!drop[wl[i]]) wl[j++] = wl[i];
      wl.resize(j);
    }
    for (size_t i = 0; i < clauses.size(); ++i)
      if (drop[i]) clauses[i].lits.clear();  // tombstone (indices stay stable)
  }

  static long luby(long i) {
    long k = 1;
    while ((1L << k) - 1 < i + 1) ++k;
    while ((1L << k) - 1 != i + 1) {
      --k;
      i = i - ((1L << k) - 1);
    }
    return 1L << (k - 1);
  }

  // returns 1 sat, 0 unsat
  int solve() {
    if (propagate() != -1) return 0;
    long restart_n = 0;
    long conflict_budget = 100 * luby(restart_n);
    std::vector<Lit> learnt;
    for (;;) {
      int confl = propagate();
      if (confl != -1) {
        ++conflicts;
        clauses[confl].activity += cla_inc;
        if (decision_level() == 0) return 0;
        int bt;
        analyze(confl, learnt, bt);
        backtrack(bt);
        if (learnt.size() == 1) {
          enqueue(learnt[0], -1);
        } else {
          int ci = (int)clauses.size();
          clauses.push_back({learnt, true, cla_inc});
          watches[widx(learnt[0])].push_back(ci);
          watches[widx(learnt[1])].push_back(ci);
          enqueue(learnt[0], ci);
        }
        var_inc /= 0.95;
        cla_inc /= 0.999;
        if (cla_inc > 1e20) {  // rescale, mirroring the var-activity bump
          for (auto& c : clauses)
            if (c.learned) c.activity *= 1e-20;
          cla_inc *= 1e-20;
        }
        if (--conflict_budget <= 0) {
          backtrack(0);
          ++restart_n;
          conflict_budget = 100 * luby(restart_n);
          reduce_learned();
        }
      } else {
        int v = pick_branch();
        if (v == 0) return 1;  // all assigned
        trail_lim.push_back((int)trail.size());
        enqueue(-v, -1);  // negative-first polarity
      }
    }
  }
};

int run_incremental() {
  Solver s;
  bool ok = true;
  bool inited = false;
  char* line = nullptr;
  size_t cap = 0;
  ssize_t len;
  std::vector<Lit> cur;
  while ((len = getline(&line, &cap, stdin)) >= 0) {
    char* p = line;
    while (*p == ' ' || *p == '\t') ++p;
    if (*p == 'q') break;
    if (*p == 'c' || *p == '\n' || *p == '\0') continue;
    if (*p == 'p') {
      while (*p && *p != ' ') ++p;
      while (*p == ' ') ++p;
      while (*p && *p != ' ') ++p;  // skip "cnf"
      long nv = strtol(p, &p, 10);
      strtol(p, &p, 10);  // clause count: informational
      s.init((int)nv);
      inited = true;
      continue;
    }
    if (*p == 's') {
      if (!inited) return 1;
      if (ok && s.solve()) {
        printf("r sat\nv ");
        for (int v = 1; v <= s.nvars; ++v)
          printf("%d ", s.assigns[v] >= 0 ? v : -v);
        printf("0\n");
      } else {
        ok = false;  // level-0 conflict: all later solves stay unsat
        printf("r unsat\n");
      }
      fflush(stdout);
      continue;
    }
    if (*p == 'a') ++p;  // "a <lits> 0" — also accept bare clause lines
    if (!inited) return 1;
    s.backtrack(0);
    cur.clear();
    for (;;) {
      long l = strtol(p, &p, 10);
      if (l == 0) break;
      cur.push_back((Lit)l);
    }
    if (!s.add_clause(cur, false)) ok = false;
  }
  free(line);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc > 1 && strcmp(argv[1], "-i") == 0) return run_incremental();
  // read all of stdin
  std::vector<char> buf;
  {
    char tmp[1 << 16];
    size_t n;
    while ((n = fread(tmp, 1, sizeof tmp, stdin)) > 0)
      buf.insert(buf.end(), tmp, tmp + n);
    buf.push_back('\0');
  }
  Solver s;
  char* p = buf.data();
  long nv = 0, nc = 0;
  std::vector<Lit> cur;
  bool ok = true;
  while (*p) {
    while (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r') ++p;
    if (!*p) break;
    if (*p == 'c') {
      while (*p && *p != '\n') ++p;
      continue;
    }
    if (*p == 'p') {
      // p cnf nv nc
      while (*p && *p != ' ') ++p;
      while (*p == ' ') ++p;
      while (*p && *p != ' ') ++p;  // skip "cnf"
      nv = strtol(p, &p, 10);
      nc = strtol(p, &p, 10);
      (void)nc;
      s.init((int)nv);
      continue;
    }
    long l = strtol(p, &p, 10);
    if (l == 0) {
      if (!s.add_clause(cur, false)) ok = false;
      cur.clear();
    } else {
      cur.push_back((Lit)l);
    }
  }
  if (!cur.empty() && !s.add_clause(cur, false)) ok = false;

  if (ok && s.solve()) {
    printf("s SATISFIABLE\nv ");
    for (int v = 1; v <= s.nvars; ++v)
      printf("%d ", s.assigns[v] >= 0 ? v : -v);  // unset → true, arbitrary
    printf("0\n");
    return 10;
  }
  printf("s UNSATISFIABLE\n");
  return 20;
}
